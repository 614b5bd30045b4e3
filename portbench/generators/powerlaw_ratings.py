"""A ratings matrix of a stated shape and exact number of distinct entries,
drawn on the device from the seed.

Rows and columns are drawn from Pareto (Lomax) marginals, ``min(floor(x *
size / scale_div), size - 1)`` with ``x ~ Lomax(shape)``, through a random
renumbering of the ids, as the repository's ratings-like generator draws
them; draws go on in batches (``draws_per_batch``) until the configuration's
``nnz`` distinct (row, col) pairs exist, and of the last batch the new pairs
are kept in the order they were drawn.  Values are on the configuration's
rating grid (``rating_step`` times 1 .. ``rating_levels``).  Entries are
returned in row-major order.
"""

from __future__ import annotations

import torch

from portbench.common import generator


def draws_per_batch(nnz: int) -> int:
    """Pairs drawn at a time: as many as the matrix has entries, from 4,096
    up to 8M."""
    return min(1 << 23, max(1 << 12, nnz))


def _index(size, shape, scale_div, count, gen, device):
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    x = (1.0 - u).pow(-1.0 / shape) - 1.0
    return (x * (size / scale_div)).floor_().clamp_(max=size - 1).long()


def make(cfg: dict, seed: int, device) -> dict:
    p, n, nnz = cfg["rows"], cfg["cols"], cfg["nnz"]
    if nnz > p * n:
        raise ValueError(f"{nnz} distinct entries do not fit {p} x {n}")
    gen = generator(device, seed, "entries")
    row_id = torch.randperm(p, generator=gen, device=device)
    col_id = torch.randperm(n, generator=gen, device=device)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    batch = draws_per_batch(nnz)
    while keys.numel() < nnz:
        r = _index(p, cfg["pareto_shape"], cfg["pareto_scale_div"], batch, gen, device)
        c = _index(n, cfg["pareto_shape"], cfg["pareto_scale_div"], batch, gen, device)
        drawn = row_id[r] * n + col_id[c]
        drawn = drawn[~torch.isin(drawn, keys)]
        new, inv = torch.unique(drawn, return_inverse=True)
        need = nnz - keys.numel()
        if new.numel() > need:
            # the first ``need`` new pairs in draw order
            first = torch.full((new.numel(),), drawn.numel(), dtype=torch.int64, device=device)
            first.scatter_reduce_(0, inv, torch.arange(drawn.numel(), device=device), "amin")
            new = new[first.argsort()[:need]]
        keys = torch.cat([keys, new])
    keys = keys.sort().values
    levels = torch.randint(1, cfg["rating_levels"] + 1, (nnz,), generator=gen, device=device)
    return {
        "kind": "sparse",
        "shape": (p, n),
        "rows": (keys // n).to(torch.int32),
        "cols": (keys % n).to(torch.int32),
        "vals": levels.to(torch.float32) * cfg["rating_step"],
    }
