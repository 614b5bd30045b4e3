"""Carrying state across from the JAX package.

A tiled store, a pair of factors, a solver's options or a solve's ``Result``
made by ``nmf_tpu`` crosses over as plain numpy and plain Python values: the
caller turns each array field into ``np.ndarray`` (``np.asarray``) and hands
the dicts to these functions, which never see a JAX object.  A BCOO X
crosses as its ``indices`` and ``data`` (``sparse_from_numpy``).

A checkpoint directory written by the JAX package's ``solve_checkpointed``
needs no conversion: its files are plain ``.npz`` arrays, and
``models.checkpoint.load_state`` (and so ``solve_checkpointed``) resumes
from one directly for the solvers whose state is arrays only (MU, GreedyCD,
ProjectedALS, ALSPGrad).  A Fast-HALS file holds a JAX random key where the
port keeps a ``torch.Generator``'s state, and is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config
from .models.alspgrad import ALSPGrad
from .models.common import Result, Trace
from .models.coorddesc import CoordinateDescent
from .models.greedycd import GreedyCD
from .models.multupd import MultUpdate
from .models.projals import ProjectedALS
from .models.spa import SPA
from .ops.sparse_format import (
    INDEX_FIELDS,
    SparseCSR,
    TiledCSR,
    TiledSideC,
    row_panel_index,
    side_from_numpy,
    to_tensor,
)

__all__ = ["tiled_from_numpy", "sparse_from_numpy", "factors_from_numpy",
           "solver_from_fields", "result_from_numpy"]

_SOLVERS = {cls.__name__: cls for cls in (
    CoordinateDescent, GreedyCD, MultUpdate, ProjectedALS, ALSPGrad, SPA)}

_SIDE_FIELDS = tuple(
    f for f in TiledSideC.__dataclass_fields__ if f not in INDEX_FIELDS
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
    int32 per chunk / block / quad sub-segment and the row-panel index (with
    its pieces) is derived."""
    dev = config.resolve_device(device)
    top = {name: to_tensor(d.get(name), dev) for name in _TOP_ARRAYS}
    return TiledCSR(
        fwd=side_from_numpy(_side(d["fwd"]), dev),
        bwd=side_from_numpy(_side(d["bwd"]), dev),
        shape=tuple(int(s) for s in d["shape"]),
        build_opts=None if d.get("build_opts") is None else tuple(d["build_opts"]),
        **top,
    )


def sparse_from_numpy(indices, data, shape, device=config.DEFAULT_DEVICE) -> SparseCSR:
    """The port's general sparse X (``SparseCSR``) on ``device`` from a
    BCOO's arrays as numpy: ``indices`` ``(nnz, 2)`` (row, column) pairs,
    ``data`` ``(nnz,)`` values of any float type, kept; duplicates are
    summed."""
    dev = config.resolve_device(device)
    idx = to_tensor(np.asarray(indices, np.int64).reshape(-1, 2).T, dev)
    X = torch.sparse_coo_tensor(idx, to_tensor(np.asarray(data), dev),
                                tuple(int(s) for s in shape), check_invariants=False)
    return SparseCSR.from_torch_sparse(X)


def factors_from_numpy(W, H, device=config.DEFAULT_DEVICE):
    """``(W, H)`` as tensors on ``device`` from numpy arrays."""
    dev = config.resolve_device(device)
    return to_tensor(np.asarray(W), dev), to_tensor(np.asarray(H), dev)


def solver_from_fields(name, fields):
    """The port's options object from the name of an ``nmf_tpu`` options
    dataclass (``"CoordinateDescent"``, ``"GreedyCD"``, ``"MultUpdate"``,
    ``"ProjectedALS"``, ``"ALSPGrad"``, ``"SPA"``) and its fields as a dict of plain Python values.  Fields the port's class
    does not have (the JAX random ``key``: the port draws from a
    ``torch.Generator``) are left out; the port's own validation runs."""
    if name not in _SOLVERS:
        raise ValueError(f"unknown solver {name!r}; known: {sorted(_SOLVERS)}")
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
