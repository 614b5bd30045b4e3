"""Factor initializers.  ``randinit`` only so far; the NNDSVD family waits
for the randomized SVD."""

from __future__ import annotations

import torch

from .. import config
from ..utils.numeric import normalize1_cols

__all__ = ["randinit"]


def randinit(X_or_shape, k: int, *, normalize: bool = False, zeroh: bool = False,
             generator=None, dtype=None, device=config.DEFAULT_DEVICE):
    """Uniform random init: ``W ~ U[0,1)`` (optionally column-sum
    normalized), ``H ~ U[0,1)`` or zeros when ``zeroh``.  ``generator`` is a
    CPU ``torch.Generator`` (seed 0 when not given): the numbers are drawn on
    the host and moved to ``device``, so one seed gives one init whatever the
    device."""
    dev = config.resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if hasattr(X_or_shape, "shape"):
        p, n = X_or_shape.shape
        dtype = dtype or X_or_shape.dtype
    else:
        p, n = X_or_shape
        dtype = dtype or torch.float32
    W = torch.rand((p, k), generator=generator, dtype=dtype).to(dev)
    if normalize:
        W = normalize1_cols(W)
    if zeroh:
        H = torch.zeros((k, n), dtype=dtype, device=dev)
    else:
        H = torch.rand((k, n), generator=generator, dtype=dtype).to(dev)
    return W, H
