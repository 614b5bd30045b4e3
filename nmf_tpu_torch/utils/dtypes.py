"""Dtype-parametric numeric constants.

The reference library is generic over the element type ``T`` and derives its
tolerances from ``eps(T)`` (per-solver ``tol = cbrt(eps(T))``, ``nnmf``
top-level ``tol = cbrt(eps(T)/100)``).  Every default here is a function of
the working dtype, so float32 (the card's working type) and float64 (the
parity-test type) both behave like the reference does for the same ``T``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["eps", "sqrt_eps", "cbrt_eps", "default_tol", "canonical_dtype"]

_NP_OF_TORCH = {
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


def canonical_dtype(dtype) -> np.dtype:
    """Canonicalize a torch or numpy dtype-like to a numpy floating dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NP_OF_TORCH:
            raise TypeError(f"Expected a floating dtype, got {dtype}")
        dtype = _NP_OF_TORCH[dtype]
    d = np.dtype(dtype)
    if d.kind != "f":
        raise TypeError(f"Expected a floating dtype, got {d}")
    return d


def eps(dtype) -> float:
    """Machine epsilon for ``dtype`` (Julia ``eps(T)``)."""
    return float(np.finfo(canonical_dtype(dtype)).eps)


def sqrt_eps(dtype) -> float:
    """``sqrt(eps(T))`` — the multiplicative updates' denominator guard."""
    return float(np.sqrt(eps(dtype)))


def cbrt_eps(dtype) -> float:
    """``cbrt(eps(T))`` — the per-solver default tolerance."""
    return float(np.cbrt(eps(dtype)))


def default_tol(dtype) -> float:
    """``cbrt(eps(T)/100)`` — the ``nnmf`` front-door default tolerance:
    ~1.305e-6 for float64, ~1.06e-3 for float32."""
    return float(np.cbrt(eps(dtype) / 100.0))
