"""Carrying state across from the JAX package.

A tiled store, a pair of factors, a solver's options or a solve's ``Result``
made by ``nmf_tpu`` crosses over as plain numpy and plain Python values: the
caller turns each array field into ``np.ndarray`` (``np.asarray``) and hands
the dicts to these functions, which never see a JAX object.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import config
from .models.common import Result, Trace
from .models.coorddesc import CoordinateDescent
from .models.greedycd import GreedyCD
from .models.multupd import MultUpdate
from .ops.sparse_format import (
    TiledCSR,
    TiledSideC,
    row_panel_index,
    side_from_numpy,
    to_tensor,
)

__all__ = ["tiled_from_numpy", "factors_from_numpy", "solver_from_fields",
           "result_from_numpy"]

_SOLVERS = {"CoordinateDescent": CoordinateDescent, "GreedyCD": GreedyCD,
            "MultUpdate": MultUpdate}

_SIDE_FIELDS = tuple(
    f for f in TiledSideC.__dataclass_fields__
    if f not in ("panel_ptr", "panel_chunks", "dpanel_ptr", "dpanel_blocks",
                 "qpanel_ptr", "qpanel_segs")
)
_TOP_ARRAYS = ("row_idx", "col_idx", "values", "row_perm", "row_rank",
               "col_perm", "col_rank", "stats")


def _unpack_bytes(words):
    """Row panels stored four to an int32 word (byte lanes) -> one int32
    each, flat."""
    w = np.asarray(words, np.int32).reshape(-1)
    return ((w[:, None] >> (8 * np.arange(4, dtype=np.int32))) & 0xFF).reshape(-1)


def _side(d) -> dict:
    f = {name: d[name] for name in _SIDE_FIELDS if name in d}
    for name in ("chunk_rp", "dblk_rp", "q_rp"):
        if f.get(name) is not None:
            f[name] = _unpack_bytes(f[name])
    f.update(row_panel_index(f))
    return f


def tiled_from_numpy(d, device=config.DEFAULT_DEVICE) -> TiledCSR:
    """The port's ``TiledCSR`` on ``device`` from the fields of an ``nmf_tpu``
    ``TiledCSR`` given as a dict: ``fwd`` and ``bwd`` are dicts of that
    side's fields, every array a numpy array, every count an int.  The
    byte-packed ``chunk_rp`` / ``dblk_rp`` / ``q_rp`` are unpacked to one
    int32 per chunk / block / quad sub-segment and the row-panel index is
    derived."""
    dev = config.resolve_device(device)
    top = {name: to_tensor(d.get(name), dev) for name in _TOP_ARRAYS}
    return TiledCSR(
        fwd=side_from_numpy(_side(d["fwd"]), dev),
        bwd=side_from_numpy(_side(d["bwd"]), dev),
        shape=tuple(int(s) for s in d["shape"]),
        build_opts=None if d.get("build_opts") is None else tuple(d["build_opts"]),
        **top,
    )


def factors_from_numpy(W, H, device=config.DEFAULT_DEVICE):
    """``(W, H)`` as tensors on ``device`` from numpy arrays."""
    dev = config.resolve_device(device)
    return to_tensor(np.asarray(W), dev), to_tensor(np.asarray(H), dev)


def solver_from_fields(name, fields):
    """The port's options object from the name of an ``nmf_tpu`` options
    dataclass (``"CoordinateDescent"``, ``"GreedyCD"``, ``"MultUpdate"``) and
    its fields as a dict of plain Python values.  Fields the port's class
    does not have (the JAX random ``key``: the port draws from a
    ``torch.Generator``) are left out; the port's own validation runs."""
    if name not in _SOLVERS:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet; ported: {sorted(_SOLVERS)}"
        )
    cls = _SOLVERS[name]
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in fields.items() if k in known})


def result_from_numpy(d, device=config.DEFAULT_DEVICE) -> Result:
    """A ``Result`` on ``device`` from the fields of an ``nmf_tpu`` ``Result``
    given as a dict: ``W`` and ``H`` numpy arrays, ``niters``, ``converged``
    and ``objvalue`` plain values, ``trace`` None or a pair of numpy arrays
    ``(objvalue, relchange)``."""
    dev = config.resolve_device(device)
    W, H = factors_from_numpy(d["W"], d["H"], dev)
    trace = d.get("trace")
    if trace is not None:
        trace = Trace(*(to_tensor(np.asarray(a), dev) for a in trace))
    return Result(W, H, int(d["niters"]), bool(d["converged"]),
                  float(d["objvalue"]), trace=trace)
