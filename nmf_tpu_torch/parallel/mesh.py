"""Device mesh for the sharded path.

The workload's two scalable dimensions are p (rows of X and W) and n
(columns of X and H); k stays whole.  A mesh is a 2-D ("rows", "cols") grid
of ``torch.device``s driven by one process, as the JAX package's mesh is
driven by one controller: X is cut into one block of the grid a device
(``ops/sparse_shard.py``, ``ops/dense_shard.py``), and W and H stay whole on
the mesh's first device, its *lead*.  A device may stand in the grid more
than once, so a 2 x 2 mesh runs on one card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config

__all__ = ["Mesh", "make_mesh", "auto_mesh_shape", "init_distributed", "ROWS",
           "COLS"]

ROWS = "rows"
COLS = "cols"


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor ``n_devices`` into the most-square (rows, cols) grid."""
    r = int(math.isqrt(n_devices))
    while n_devices % r:
        r -= 1
    return (r, n_devices // r)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (R, C) grid of devices; ``devices[i, j]`` holds X's block (i, j)."""

    devices: np.ndarray  # (R, C) object array of torch.device

    @property
    def shape(self) -> dict[str, int]:
        """``{ROWS: R, COLS: C}``, read as ``mesh.shape[ROWS]``."""
        return {ROWS: self.devices.shape[0], COLS: self.devices.shape[1]}

    @property
    def lead(self) -> torch.device:
        """The device that holds W, H and the sums of the blocks' partials."""
        return self.devices[0, 0]

    def _key(self):
        return self.devices.shape, tuple(self.devices.reshape(-1))

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
    mesh by itself."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() found no CUDA device; pass devices= explicitly "
                "(e.g. ['cpu'] * 8) to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if shape is None:
        shape = auto_mesh_shape(len(devices))
    if shape[0] * shape[1] != len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} does not cover {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)))


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """One process a card is not ported yet: the mesh here is driven by one
    process (ROADMAP.md, queue 1 item 6c)."""
    raise NotImplementedError(
        "init_distributed: one process a card is ROADMAP.md queue 1 item 6c; "
        "a mesh here is driven by one process (make_mesh)")
