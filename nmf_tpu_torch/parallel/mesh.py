"""Device mesh for the sharded path.

The workload's two scalable dimensions are p (rows of X and W) and n
(columns of X and H); k stays whole.  A mesh is a 2-D ("rows", "cols") grid
of cells, one block of X a cell (``ops/sparse_shard.py``,
``ops/dense_shard.py``).  One process may drive the whole grid, as the JAX
package's mesh is driven by one controller; or several processes, one card
each (``init_distributed``), each driving the cells it owns.  Either way W
and H stay whole on every process's first device, its *lead*, and the
blocks' partials are added there in one fixed order
(``parallel/exchange.py``), so every process takes the same steps on the
same bits.  A device may stand in the grid more than once, so a 2 x 2 mesh
runs on one card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config

__all__ = ["Mesh", "make_mesh", "auto_mesh_shape", "init_distributed",
           "process_group", "ROWS", "COLS"]

ROWS = "rows"
COLS = "cols"


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor ``n_devices`` into the most-square (rows, cols) grid."""
    r = int(math.isqrt(n_devices))
    while n_devices % r:
        r -= 1
    return (r, n_devices // r)


def process_group() -> tuple[int, int]:
    """(this process's rank, number of processes) of the default
    ``torch.distributed`` group; (0, 1) when none is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (R, C) grid of cells; cell (i, j) holds X's block (i, j).

    ``ranks[i, j]`` is the process that owns the cell and ``rank`` is this
    process; ``devices[i, j]`` is the cell's device where this process owns
    it and None elsewhere.  A mesh of one process owns every cell."""

    devices: np.ndarray  # (R, C) object array of torch.device (or None)
    ranks: np.ndarray  # (R, C) int64: the process that owns each cell
    rank: int = 0

    @property
    def shape(self) -> dict[str, int]:
        """``{ROWS: R, COLS: C}``, read as ``mesh.shape[ROWS]``."""
        return {ROWS: self.devices.shape[0], COLS: self.devices.shape[1]}

    @property
    def processes(self) -> int:
        """How many processes the grid spans."""
        return int(self.ranks.max()) + 1

    @property
    def lead(self) -> torch.device:
        """This process's first device (its first cell, row major): it holds
        W, H and the sums of the blocks' partials."""
        return self.devices[self.ranks == self.rank][0]

    def _key(self):
        return (self.devices.shape, tuple(self.devices.reshape(-1)),
                tuple(self.ranks.reshape(-1).tolist()), self.rank)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index: ``cuda`` alone is the
    current card.  Raises for a card when none is available."""
    dev = config.resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A ("rows", "cols") mesh over ``devices`` (default: every visible card,
    ``cuda:0`` first).  A list may repeat a device: ``["cuda:0"] * 4`` makes
    a 2 x 2 mesh on one card, ``["cpu"] * 8`` the tests' (2, 4) mesh.  With no
    card visible and no ``devices`` given it raises; it never builds a CPU
    mesh by itself.

    In a process group of several processes (``init_distributed``) every
    process calls it with the same ``shape`` and as many ``devices`` of its
    own: the cells are dealt out rank major (process 0 owns the first
    ``R * C / processes`` cells in row-major order), so the grid must split
    evenly among the processes."""
    rank, world = process_group()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device; pass devices= explicitly "
                "(e.g. ['cpu'] * 8) to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if shape is None:
        shape = auto_mesh_shape(len(devices) * world)
    shape = tuple(shape)
    cells = shape[0] * shape[1]
    if cells % world:
        raise ValueError(
            f"mesh shape {shape} does not split evenly among {world} processes")
    if cells != len(devices) * world:
        raise ValueError(
            f"mesh shape {shape} does not cover {len(devices)} devices"
            + (f" on each of {world} processes" if world > 1 else ""))
    grid = np.full(cells, None, dtype=object)
    grid[rank * len(devices):(rank + 1) * len(devices)] = devices
    ranks = np.repeat(np.arange(world, dtype=np.int64), len(devices))
    return Mesh(grid.reshape(shape), ranks.reshape(shape), rank)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, timeout: float = 600.0):
    """Join the processes of a mesh that spans several, as the JAX package's
    ``init_distributed`` joins them through ``jax.distributed.initialize``:
    the default ``torch.distributed`` process group at
    ``coordinator_address`` ("host:port", where process 0 listens) with
    ``num_processes`` processes, this one ``process_id``.  With all three
    None the group is read from the environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as
    ``torchrun`` sets them).

    ``backend`` is ``"nccl"`` (the default: one card a process) or
    ``"gloo"`` (CPU cells, or several processes on one card, which NCCL
    refuses: each partial then goes through the host); it is never swapped
    for another.  ``timeout`` (seconds) bounds every collective, so a
    process whose peer died fails instead of waiting.  A no-op when a group
    is already initialized."""
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    given = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError(
            "init_distributed: pass coordinator_address, num_processes and "
            "process_id together, or none of them (the group is then read "
            "from the environment)")
    backend = "nccl" if backend is None else backend
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed(backend='nccl') found no CUDA device; pass "
            "backend='gloo' to join processes over the CPU")
    if all(given):
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=int(num_processes), rank=int(process_id))
    else:
        kw = dict(init_method="env://")
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout), **kw)
