"""A dense non-negative matrix of a stated rank plus uniform noise, made on
the device from the seed: ``X = Wg @ Hg + noise * U`` with ``Wg``, ``Hg``
and ``U`` uniform on [0, 1), the product in full float32, a block of rows at
a time so that no second copy of X is ever held."""

from __future__ import annotations

import torch

from portbench.common import generator, ieee_matmul

ROWS_PER_BLOCK = 8192


def make(cfg: dict, seed: int, device) -> dict:
    p, n, r = cfg["rows"], cfg["cols"], cfg["signal_rank"]
    gen = generator(device, seed, "X")
    Wg = torch.rand((p, r), generator=gen, device=device)
    Hg = torch.rand((r, n), generator=gen, device=device)
    X = torch.empty((p, n), device=device)
    with ieee_matmul():
        for i0 in range(0, p, ROWS_PER_BLOCK):
            blk = X[i0:i0 + ROWS_PER_BLOCK]
            torch.mm(Wg[i0:i0 + ROWS_PER_BLOCK], Hg, out=blk)
            blk.add_(torch.rand(blk.shape, generator=gen, device=device), alpha=cfg["noise"])
    return {"kind": "dense", "shape": (p, n), "X": X}
