"""Lee-Seung multiplicative updates (MSE and KL-divergence objectives).

* The MSE H-step needs ``W'X`` and ``W'W H``; the latter is taken in the Gram
  form ``(W'W) H`` (O(p k^2 + k^2 n) flops instead of O(p k n)), which never
  touches X or a p x n buffer.
* The divergence updater's p x n quotient ``Q = X ./ (W H + delta)`` is the
  memory hot spot.  For a sparse X it is a sampled product at X's pattern
  (``matops.sddmm``) and a value refresh of the store; for a dense float32 X
  on the card the kernels of ``ops/cuda/mu.py`` form it tile by tile and it
  never reaches device memory.  The MSE factor steps of such an X go through
  ``mu_factor_update``, which keeps ``G @ F`` inside the kernel.
* Tensors on the CPU and float64 take the plain expressions.
"""

from __future__ import annotations

import dataclasses
import warnings

from ..ops import matops
from ..ops.objectives import kl_objective, mse_objective
from ..utils.dtypes import cbrt_eps, sqrt_eps
from .common import Result, nmf_skeleton, register_solver

__all__ = ["MultUpdate"]


@dataclasses.dataclass(frozen=True)
class MultUpdate:
    """Options for multiplicative updates.

    ``lambda_w``/``lambda_h`` are L1 regularization coefficients.  For the
    divergence objective they are floored at ``sqrt(eps(T))`` — applied at
    solve time since the floor depends on the working dtype.
    """

    obj: str = "mse"
    maxiter: int = 100
    verbose: bool = False
    tol: float | None = None
    update_H: bool = True
    lambda_w: float = 0.0
    lambda_h: float = 0.0

    # Deprecated ``lambda`` keyword: maps onto lambda_w/lambda_h where those
    # are zero.  Python reserves ``lambda``, so the keyword is ``lam``.
    lam: dataclasses.InitVar = None

    def __post_init__(self, lam=None):
        if lam is not None and isinstance(lam, (int, float)) and lam >= 0:
            warnings.warn(
                "lam is deprecated, use lambda_w and lambda_h instead.",
                DeprecationWarning,
            )
            if self.lambda_w == 0:
                object.__setattr__(self, "lambda_w", lam)
            if self.lambda_h == 0:
                object.__setattr__(self, "lambda_h", lam)
        if self.obj not in ("mse", "div"):
            raise ValueError("Invalid value for obj.")
        if self.maxiter <= 1:
            raise ValueError("maxiter must be greater than 1.")
        if self.tol is not None and not (self.tol > 0):
            raise ValueError("tol must be positive.")
        if self.lambda_w < 0:
            raise ValueError("lambda_w must be non-negative.")
        if self.lambda_h < 0:
            raise ValueError("lambda_h must be non-negative.")

    def _resolved(self, dtype):
        tol = self.tol if self.tol is not None else cbrt_eps(dtype)
        return self, tol

    def _solve(self, X, W, H, trace: bool = False) -> Result:
        upd, tol = self._resolved(W.dtype)
        return nmf_skeleton(upd, X, W, H, self.maxiter, self.verbose, tol, trace)


def _prepare(upd: MultUpdate, X, W, H):
    return ()


def _update(upd: MultUpdate, state, X, W, H):
    if upd.obj == "mse":
        return _update_mse(upd, state, X, W, H)
    return _update_div(upd, state, X, W, H)


def _update_mse(upd: MultUpdate, state, X, W, H):
    """One MU sweep for MSE: ``H .*= max(0, W'X - l_h) ./ (W'W H + delta)``
    then ``W .*= max(0, X H' - l_w) ./ (W H H' + delta)``."""
    delta = sqrt_eps(W.dtype)
    lam_w, lam_h = float(upd.lambda_w), float(upd.lambda_h)
    use_kernels = matops.is_dense_f32_on_card(X)
    if use_kernels:
        from ..ops.cuda.mu import mu_factor_update

        # the kernel reads a factor row-major or as the transposed view of a
        # row-major tensor: settle the layout once (no copy as a rule)
        W, H = W.contiguous(), H.contiguous()

    if upd.update_H:
        WtX = matops.mtm(W.T, X)
        if use_kernels:
            H = mu_factor_update(H, W.T @ W, WtX, lam_h, delta)
        else:
            WtWH = (W.T @ W) @ H
            H = H * ((WtX - lam_h).clamp_min(0) / (WtWH + delta))

    XHt = matops.mm(X, H.T)
    if use_kernels:
        W = mu_factor_update(W.T, H @ H.T, XHt.T, lam_w, delta).T
    else:
        WHHt = W @ (H @ H.T)
        W = W * ((XHt - lam_w).clamp_min(0) / (WHHt + delta))
    return W, H, state


def _update_div(upd: MultUpdate, state, X, W, H):
    """One MU sweep for generalized KL:
    ``H[i,j] *= (W'Q)[i,j] / (colsum(W)[i] + l_h)`` with
    ``Q = X ./ (W H + delta)``, then the mirrored W step with fresh Q."""
    delta = sqrt_eps(W.dtype)
    # the divergence objective floors the regularizers at sqrt(eps(T))
    lam_w = max(float(upd.lambda_w), delta)
    lam_h = max(float(upd.lambda_h), delta)
    use_kernels = matops.is_dense_f32_on_card(X)
    if use_kernels:
        from ..ops.cuda.mu import qht, wtq

    def quotient(W, H):
        # for sparse X this is a sampled product at X's pattern (0/y = 0) and
        # the dense p x n WH is never formed
        if matops.is_sparse(X):
            wh_at_nnz = matops.sddmm(W, H, X)
            return matops.scale_values(X, matops.nnz_values(X) / (wh_at_nnz + delta))
        return X / (W @ H + delta)

    if upd.update_H:
        if use_kernels:
            WtQ = wtq(X, W, H, delta)
        else:
            WtQ = matops.mtm(W.T, quotient(W, H))
        sW = W.sum(dim=0)  # (k,)
        H = H * (WtQ / (sW[:, None] + lam_h))

    if use_kernels:
        QHt = qht(X, W, H, delta)
    else:
        QHt = matops.mm(quotient(W, H), H.T)
    sH = H.sum(dim=1)  # (k,)
    W = W * (QHt / (sH[None, :] + lam_w))
    return W, H, state


def _objective(upd: MultUpdate, state, X, W, H):
    if upd.obj == "mse":
        return mse_objective(X, W, H)
    return kl_objective(X, W, H)


# Both objectives are renumber-equivariant: mse consumes X only through
# mm/mtm; div's quotient refresh speaks the CSR-order value layout
# (nnz_values / sddmm / with_values), which renumbering never touches — the
# CSR arrays keep their order and the perm/inv slot maps already target the
# renumbered tiling.
register_solver(MultUpdate, prepare=_prepare, update=_update,
                objective=_objective, renumber_safe=True)
