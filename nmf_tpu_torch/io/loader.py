"""Matrix Market loading and the host binner helpers of ``build_tiled``.

``load_mtx`` parses a Matrix Market coordinate file into COO arrays,
``coo_to_csr`` sorts and sums duplicates, and ``to_bcoo`` hands the result to
the solvers as a coalesced torch sparse tensor on the device (the JAX
package's function of the same name makes a BCOO).  ``ops/sparse_format.py``
and ``ops/sparse_shard.py`` bin a COO matrix into tiled stores on the host;
the other helpers are the array passes they are written in terms of.

Each function runs in the host library ``csrc/host/nmf_host.cpp``
(``io.native``: multithreaded C++, built with the host's C++ compiler at the
first call that takes this route) and has a plain numpy version,
``_<name>_plain``, that gives the same arrays bit for bit.  The routing is
the JAX package's: ``load_mtx`` and ``coo_to_csr`` always take the library
(a compressed ``.gz`` / ``.bz2`` file, which it cannot read, goes through
scipy, and so does a COO whose values are not float32), the binner's helpers
from ``1 << 16`` elements on, numpy below.  A missing compiler or a failed
build raises; there is no fallback to numpy.  ``_plain_route()`` pins every
function to its plain version (the tests and ``chip_smoke.py`` compare the
two).

Both routes read real, integer and pattern files, general, symmetric,
skew-symmetric and hermitian ones (a hermitian file of real values is
symmetric), with scipy's entries in scipy's order (the file's entries, then
the mirrors of the off-diagonal ones; a skew-symmetric mirror is -v), and
refuse array and complex files with a ``ValueError``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from . import native

__all__ = [
    "COO", "CSR", "load_mtx", "coo_to_csr", "to_bcoo", "native_available",
    "stable_argsort", "gather3", "gather3k", "dense_scatter",
    "tile_key", "chunk_fill", "class_extract",
]

# the binner's helpers take the library from this many elements on (the JAX
# package's rule)
NATIVE_MIN = 1 << 16

_plain = False


@contextlib.contextmanager
def _plain_route():
    """Every function of this module on its plain numpy version inside the
    block."""
    global _plain
    saved, _plain = _plain, True
    try:
        yield
    finally:
        _plain = saved


def _native(n: int) -> bool:
    """Whether a helper call over ``n`` elements takes the library."""
    return not _plain and n >= NATIVE_MIN


def _common_len(*arrays) -> int:
    """The length of the shortest array: the library reads at most that
    many entries of each."""
    return min(len(a) for a in arrays)


def _check(name: str, rc: int) -> None:
    if rc:
        raise IndexError(f"{name}: an index is out of range")


def native_available() -> bool:
    """Whether the host library builds (or is built) and loads here."""
    try:
        native.load()
    except RuntimeError:
        return False
    return True


class COO(NamedTuple):
    rows: int
    cols: int
    row_idx: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray


class CSR(NamedTuple):
    rows: int
    cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray


def load_mtx(path: str) -> COO:
    """Parse a Matrix Market coordinate file into COO arrays (int32
    indices, float32 values; duplicates are kept)."""
    if _plain or str(path).endswith((".gz", ".bz2")):
        return _load_mtx_plain(path)
    lib = native.load()
    res = native.MtxResult()
    rc = lib.nmf_load_mtx(os.fsencode(path), ctypes.byref(res))
    if rc == 1:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such file: {path}")
        raise OSError(f"cannot read {path}")
    if rc:
        raise ValueError(f"Unsupported or malformed MatrixMarket file: {path}")
    arrays = [_adopt(lib, ptr, res.nnz, dt) for ptr, dt in (
        (res.row_idx, np.int32), (res.col_idx, np.int32), (res.values, np.float32))]
    return COO(int(res.rows), int(res.cols), *arrays)


def _adopt(lib, ptr, n: int, dtype) -> np.ndarray:
    """The library's ``malloc``-ed array of ``n`` items as a numpy array,
    without a copy; ``nmf_free`` releases it when the last view of it is
    gone."""
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    buf = (ctypes.c_char * (n * np.dtype(dtype).itemsize)).from_address(addr)
    weakref.finalize(buf, lib.nmf_free, addr)
    return np.frombuffer(buf, dtype)


def _load_mtx_plain(path: str) -> COO:
    import scipy.io

    *_, fmt, field, _ = scipy.io.mminfo(str(path))
    if fmt != "coordinate" or field == "complex":
        raise ValueError(f"Unsupported MatrixMarket format ({fmt} {field}): "
                         f"{path}")
    m = scipy.io.mmread(str(path)).tocoo()
    return COO(
        m.shape[0],
        m.shape[1],
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        m.data.astype(np.float32),
    )


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR, each row's columns sorted and duplicates summed (scipy's
    bits)."""
    values = np.asarray(coo.values)
    if _plain or values.dtype != np.float32:
        return _coo_to_csr_plain(coo)
    nnz = len(values)
    if len(coo.row_idx) != nnz or len(coo.col_idx) != nnz:
        raise ValueError("coo_to_csr: row_idx, col_idx and values of one length")
    indptr = np.empty(coo.rows + 1, np.int64)
    indices = np.empty(nnz, np.int32)
    data = np.empty(nnz, np.float32)
    kept = native.load().nmf_coo_to_csr(
        coo.rows, coo.cols, nnz,
        np.ascontiguousarray(coo.row_idx, np.int32),
        np.ascontiguousarray(coo.col_idx, np.int32),
        np.ascontiguousarray(values), indptr, indices, data,
    )
    if kept < 0:
        raise ValueError("coo_to_csr: a row or column index is out of range")
    return CSR(coo.rows, coo.cols, indptr, indices[:kept], data[:kept])


def _coo_to_csr_plain(coo: COO) -> CSR:
    import scipy.sparse

    m = scipy.sparse.coo_matrix(
        (coo.values, (coo.row_idx, coo.col_idx)), shape=(coo.rows, coo.cols)
    ).tocsr()
    m.sum_duplicates()
    return CSR(
        coo.rows,
        coo.cols,
        m.indptr.astype(np.int64),
        m.indices.astype(np.int32),
        m.data.astype(np.float32),
    )


def to_bcoo(x, dtype=torch.float32, device=config.DEFAULT_DEVICE):
    """COO or CSR arrays -> a coalesced ``torch.sparse_coo_tensor`` of
    ``dtype`` on ``device`` (sorted row-major, duplicates summed), as
    ``nnmf`` and the solvers take it."""
    dev = config.resolve_device(device)
    if not isinstance(x, CSR):
        x = coo_to_csr(x)
    rows = np.repeat(np.arange(x.rows, dtype=np.int64),
                     np.diff(x.indptr).astype(np.int64))
    idx = torch.from_numpy(np.stack([rows, x.indices.astype(np.int64)]))
    vals = torch.from_numpy(np.ascontiguousarray(x.data)).to(dtype)
    X = torch.sparse_coo_tensor(idx, vals, (x.rows, x.cols),
                                is_coalesced=True, check_invariants=False)
    return X.to(dev)


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of an int64 key array.  The library's radix sort
    orders non-negative keys only (and at most ``2**31 - 1`` of them);
    other arrays take numpy's."""
    keys = np.ascontiguousarray(keys, np.int64)
    n = len(keys)
    if not (_native(n) and n < (1 << 31) and int(keys.min()) >= 0):
        return _stable_argsort_plain(keys)
    order = np.empty(n, np.int64)
    native.load().nmf_argsort64(n, keys, order)
    return order


def _stable_argsort_plain(keys):
    return np.argsort(np.ascontiguousarray(keys, np.int64), kind="stable")


def gather3(order, r, c, v):
    """``(r[order], c[order], v[order])``."""
    n = len(order)
    if not _native(n):
        return _gather3_plain(order, r, c, v)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    _check("gather3", native.load().nmf_gather3(
        n, np.ascontiguousarray(order, np.int64), _common_len(r, c, v),
        np.ascontiguousarray(r, np.int32),
        np.ascontiguousarray(c, np.int32),
        np.ascontiguousarray(v, np.float32), ro, co, vo,
    ))
    return ro, co, vo


def _gather3_plain(order, r, c, v):
    return r[order], c[order], v[order]


def gather3k(order, r, c, v, k):
    """``(r[order], c[order], v[order], k[order])``."""
    n = len(order)
    if not _native(n):
        return _gather3k_plain(order, r, c, v, k)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    ko = np.empty(n, np.int64)
    _check("gather3k", native.load().nmf_gather3k(
        n, np.ascontiguousarray(order, np.int64), _common_len(r, c, v, k),
        np.ascontiguousarray(r, np.int32),
        np.ascontiguousarray(c, np.int32),
        np.ascontiguousarray(v, np.float32),
        np.ascontiguousarray(k, np.int64), ro, co, vo, ko,
    ))
    return ro, co, vo, ko


def _gather3k_plain(order, r, c, v, k):
    return r[order], c[order], v[order], k[order]


def dense_scatter(dvals: np.ndarray, blk, lcol, lrow, v):
    """``dvals[blk, lcol, lrow] = v`` (unique positions).  A ``dvals`` that
    is not C-contiguous takes numpy's route: the library writes through a
    flat view."""
    if not (_native(len(blk)) and dvals.flags.c_contiguous):
        return _dense_scatter_plain(dvals, blk, lcol, lrow, v)
    if dvals.shape[1:] != (128, 128) or _common_len(blk, lcol, lrow, v) != len(blk):
        raise ValueError("dense_scatter: dvals must be (blocks, 128, 128) and "
                         "blk, lcol, lrow, v of one length")
    _check("dense_scatter", native.load().nmf_dense_scatter(
        len(blk), np.ascontiguousarray(blk, np.int64),
        np.ascontiguousarray(lcol, np.int32),
        np.ascontiguousarray(lrow, np.int32),
        np.ascontiguousarray(v, np.float32),
        dvals.reshape(-1), dvals.shape[0],
    ))


def _dense_scatter_plain(dvals, blk, lcol, lrow, v):
    dvals[blk, lcol, lrow] = v


def tile_key(rows, cols, n_colpanels: int, stripe_tiles: int):
    """Fused tile key ``((r//128)//st * ncp + c//128)*st + (r//128)%st`` of
    non-negative rows and columns: sorting by it orders nonzeros by (stripe,
    col panel, row panel in stripe)."""
    n = len(rows)
    if not _native(n):
        return _tile_key_plain(rows, cols, n_colpanels, stripe_tiles)
    if len(cols) != n:
        raise ValueError("tile_key: rows and cols of one length")
    out = np.empty(n, np.int64)
    if native.load().nmf_tile_key(
        n, np.ascontiguousarray(rows, np.int32),
        np.ascontiguousarray(cols, np.int32), n_colpanels, stripe_tiles, out,
    ):
        raise ValueError("tile_key: a negative row or column")
    return out


def _tile_key_plain(rows, cols, n_colpanels, stripe_tiles):
    rp = rows // 128
    return (
        (rp // stripe_tiles).astype(np.int64) * n_colpanels + cols // 128
    ) * stripe_tiles + rp % stripe_tiles


def chunk_fill(t_first, counts, base, s_rows, s_cols, s_vals, cwidth,
               coords, vals):
    """Per-tile chunk-slot assignment plus the coords/vals fill over the
    tile-sorted residual; returns the flat slot id per nonzero.  ``coords``
    and ``vals`` are the flat ``(nchunks*128,)`` chunk-store arrays, modified
    in place (numpy's route when either is not C-contiguous)."""
    nnz = len(s_rows)
    if not (_native(nnz) and coords.flags.c_contiguous
            and vals.flags.c_contiguous):
        return _chunk_fill_plain(t_first, counts, base, s_rows, s_cols, s_vals,
                                 cwidth, coords, vals)
    if (_common_len(t_first, counts, base) != len(t_first)
            or _common_len(s_rows, s_cols, s_vals) != nnz or len(vals) != len(coords)):
        raise ValueError("chunk_fill: arrays of unequal lengths")
    slot = np.empty(nnz, np.int64)
    _check("chunk_fill", native.load().nmf_chunk_fill(
        len(t_first), np.ascontiguousarray(t_first, np.int64),
        np.ascontiguousarray(counts, np.int64),
        np.ascontiguousarray(base, np.int64),
        np.ascontiguousarray(s_rows, np.int32),
        np.ascontiguousarray(s_cols, np.int32),
        np.ascontiguousarray(s_vals, np.float32),
        nnz, cwidth, coords, vals, len(coords), slot,
    ))
    return slot


def _chunk_fill_plain(t_first, counts, base, s_rows, s_cols, s_vals, cwidth,
                      coords, vals):
    nnz = len(s_rows)
    pos = np.arange(nnz, dtype=np.int64) - np.repeat(t_first, counts)
    slot = (np.repeat(base, counts) + pos // 128) * 128 + pos % 128
    coords[slot] = ((s_cols % cwidth) << 7 | (s_rows % 128)).astype(np.int32)
    vals[slot] = s_vals
    return slot


def class_extract(t_first, counts, dst, a_rows, a_cols, a_vals, order):
    """Copy each tile's contiguous run of the sorted arrays to its class's
    region (``dst[t]`` = destination offset of tile t), carrying the CSR ids
    (``order``) along."""
    n = len(a_rows)
    if not _native(n):
        return _class_extract_plain(t_first, counts, dst, a_rows, a_cols,
                                    a_vals, order)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    oo = np.empty(n, np.int64)
    if (_common_len(t_first, counts, dst) != len(t_first)
            or _common_len(a_rows, a_cols, a_vals, order) != n):
        raise ValueError("class_extract: arrays of unequal lengths")
    _check("class_extract", native.load().nmf_class_extract(
        len(t_first), np.ascontiguousarray(t_first, np.int64),
        np.ascontiguousarray(counts, np.int64),
        np.ascontiguousarray(dst, np.int64),
        np.ascontiguousarray(a_rows, np.int32),
        np.ascontiguousarray(a_cols, np.int32),
        np.ascontiguousarray(a_vals, np.float32),
        np.ascontiguousarray(order, np.int64), n, ro, co, vo, oo,
    ))
    return ro, co, vo, oo


def _class_extract_plain(t_first, counts, dst, a_rows, a_cols, a_vals, order):
    n = len(a_rows)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    oo = np.empty(n, np.int64)
    d = np.repeat(dst, counts) + (
        np.arange(n, dtype=np.int64) - np.repeat(t_first, counts)
    )
    ro[d] = a_rows
    co[d] = a_cols
    vo[d] = a_vals
    oo[d] = order
    return ro, co, vo, oo
