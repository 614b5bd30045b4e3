"""The ratings matrix of ``powerlaw_ratings`` (the same draw from the same
seed), cut to the blocks of a mesh that one process holds.

A configuration with a ``mesh`` is run one process a card, each holding its
own blocks of X; every process draws the whole matrix on its own card and
keeps the entries of its blocks.  ``blocks`` lists them as ``((r0, r1), (c0,
c1))`` ranges of rows and columns, half open; the whole matrix is the one
block ``((0, rows), (0, cols))``.  Without ``blocks`` it raises before it
draws anything: a harness that does not cut the matrix over the mesh cannot
run such a cell.  Entries stay in row-major order.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.manifest import load_module

_RATINGS = load_module(Path(__file__).with_name("powerlaw_ratings.py"))


def select(data: dict, blocks) -> dict:
    """``data``'s entries that fall in ``blocks``, in their order."""
    rows, cols = data["rows"], data["cols"]
    keep = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
    for (r0, r1), (c0, c1) in blocks:
        keep |= (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    return dict(data, rows=rows[keep], cols=cols[keep], vals=data["vals"][keep])


def make(cfg: dict, seed: int, device, blocks=None) -> dict:
    if blocks is None:
        raise ValueError(
            f"{cfg.get('name', 'this configuration')} is cut over a {cfg.get('mesh')} mesh: "
            "pass the blocks this process holds (a harness that runs one process a card)")
    return select(_RATINGS.make(cfg, seed, device), blocks)
