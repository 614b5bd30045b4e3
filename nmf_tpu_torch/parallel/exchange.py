"""What the processes of a mesh that spans several exchange.

With one process a card (``mesh.init_distributed``) each process holds the
blocks of X its cells own, and W and H whole.  After a product with X every
process needs every block's partial, added in the order the one-process
mesh adds them, so that every process takes the same update steps on the
same bits.  The partials are gathered (``all_gather``) and the caller adds
them in its fixed order; no all-reduce, whose order of summation is the
library's and may differ between processes and from run to run.  The JAX
package has no module of its own for this: ``shard_map`` and
``multihost_utils`` do it there.

Bytes: a product over an R x C grid of ``local_p x k`` float32 partials
hands every process all R·C of them (R·C·local_p·k·4 bytes; 167 MB at
ttt4 on a 2 x 2 grid at k 128), each process sending its own cells'.  Over
gloo, which gathers CPU tensors only, a partial on a card goes through the
host: copied to the CPU, gathered, copied back to the lead.  Over NCCL it
stays on the cards.

With one process every function returns its input as it is, with no copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["gather_cells", "agree_sum", "agree_min"]


def _comm_device(lead: torch.device) -> torch.device:
    """Where a gathered tensor lives: the lead card when the group's backend
    moves CUDA tensors (NCCL), the host otherwise (gloo)."""
    import torch.distributed as dist

    if lead.type == "cuda" and "nccl" in dist.get_backend():
        return lead
    return torch.device("cpu")


def _all_gather(t: torch.Tensor) -> list:
    import torch.distributed as dist

    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def gather_cells(parts, ranks: np.ndarray, shapes, lead: torch.device):
    """Every cell's tensor on every process.

    ``parts`` holds R lists of C tensors, filled where this process owns the
    cell (``ranks[i, j]``, as the caller's grid is laid out; a transposed
    grid passes its transposed ranks) and None elsewhere; ``shapes[i][j]``
    is each cell's shape, known to every process.  Returns R lists of C
    tensors: this process's own as given, every other cell's on ``lead``.
    All tensors have one dtype."""
    if int(ranks.max()) == 0:
        return parts
    import torch.distributed as dist

    rank = dist.get_rank()
    R, C = ranks.shape
    cells = [(i, j) for i in range(R) for j in range(C)]
    sizes = {c: int(np.prod(shapes[c[0]][c[1]], dtype=np.int64)) for c in cells}
    by_rank = [[c for c in cells if ranks[c] == r] for r in range(dist.get_world_size())]
    room = max(sum(sizes[c] for c in own) for own in by_rank)
    mine = [parts[i][j] for i, j in by_rank[rank]]
    dev = _comm_device(lead)
    buf = torch.zeros(room, dtype=mine[0].dtype, device=dev)
    if mine:
        flat = torch.cat([t.reshape(-1).to(dev) for t in mine])
        buf[:flat.numel()] = flat
    out = [list(row) for row in parts]
    for r, got in enumerate(_all_gather(buf)):
        if r == rank:
            continue
        got = got.to(lead)
        at = 0
        for i, j in by_rank[r]:
            out[i][j] = got[at:at + sizes[i, j]].view(tuple(shapes[i][j]))
            at += sizes[i, j]
    return out


def _gathered(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """(processes, *a.shape): every process's ``a``, in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(_comm_device(mesh.lead))
    return np.stack([g.cpu().numpy() for g in _all_gather(t)])


def agree_sum(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The sum over the mesh's processes of a small host array (added in
    rank order); ``a`` itself on a mesh of one process."""
    return a if mesh.processes == 1 else _gathered(a, mesh).sum(axis=0)


def agree_min(a: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The elementwise minimum over the mesh's processes of a host array."""
    return a if mesh.processes == 1 else _gathered(a, mesh).min(axis=0)
