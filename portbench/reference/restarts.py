"""A frozen copy of how ``nmf_tpu_torch.nnmf(..., seed=s, replicates=r)``
draws its ``r - 1`` random restarts, so that the reference starts its lanes
where the program starts its own without asking the program.

``nnmf`` seeds a CPU ``torch.Generator`` with ``s`` and splits it into three
children (init, restarts, shuffle); the restarts' child is split into
``r - 1`` more.  A child is a new CPU generator seeded with one
``torch.randint(0, 2**62)`` draw of its parent.  Each restart draws ``W``
(p x k) then ``H`` (k x n) uniform on [0, 1) in float32 and scales each
column of ``W`` to sum to one (the sums taken in float64).
"""

from __future__ import annotations

import torch


def _children(gen, count):
    seeds = torch.randint(0, 2**62, (count,), generator=gen).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def starts(nnmf_seed: int, p: int, n: int, k: int, restarts: int, device):
    _, grep, _ = _children(torch.Generator().manual_seed(nnmf_seed), 3)
    out = []
    for sub in _children(grep, restarts):
        W = torch.rand((p, k), generator=sub, dtype=torch.float32)
        H = torch.rand((k, n), generator=sub, dtype=torch.float32)
        W = W / W.sum(0, dtype=torch.float64).to(torch.float32)
        out.append((W.to(device), H.to(device)))
    return out
