"""Build and load the host library, ``csrc/host/nmf_host.cpp``.

``io.loader`` runs its Matrix Market parser, its COO -> CSR conversion and
the store binner's array passes in this C++ library, on the host's cores.
The library is compiled at the first call that takes that route, with the
host's C++ compiler (``g++``, else ``c++``), into the package's ``build/``
directory (ignored by git), and loaded with ``ctypes``.  Its name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is not; it is written under a name of this process's own and
renamed, so that processes building at once each load a whole file.  There is
no ``-march=native``: a build directory never holds code for another CPU.  A
missing compiler or a failed build raises ``RuntimeError`` with the
compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils import spans

__all__ = ["load", "MtxResult", "SOURCE", "BUILD", "CXX", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "nmf_host.cpp"
BUILD = _PKG / "build"
CXX = ("g++", "c++")  # the host compilers tried, in this order
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None


class MtxResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("row_idx", ctypes.POINTER(ctypes.c_int32)),
        ("col_idx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_int32),
    ]


_I64 = ctypes.c_int64
_i32 = np.ctypeslib.ndpointer(np.int32)
_i64 = np.ctypeslib.ndpointer(np.int64)
_f32 = np.ctypeslib.ndpointer(np.float32)
_SIGNATURES = {
    "nmf_load_mtx": ([ctypes.c_char_p, ctypes.POINTER(MtxResult)], ctypes.c_int32),
    "nmf_free": ([ctypes.c_void_p], None),
    # rows, cols, nnz, row_idx, col_idx, values, indptr, indices, data
    "nmf_coo_to_csr": ([_I64] * 3 + [_i32, _i32, _f32, _i64, _i32, _f32], _I64),
    # n, keys, order
    "nmf_argsort64": ([_I64, _i64, _i64], _I64),
    # n, order, n_src, r, c, v, ro, co, vo
    "nmf_gather3": ([_I64, _i64, _I64, _i32, _i32, _f32, _i32, _i32, _f32], _I64),
    # n, blk, lcol, lrow, v, dvals, n_blocks
    "nmf_dense_scatter": ([_I64, _i64, _i32, _i32, _f32, _f32, _I64], _I64),
    # n, rows, cols, n_colpanels, stripe_tiles, key
    "nmf_tile_key": ([_I64, _i32, _i32, _I64, _I64, _i64], _I64),
    # n, order, n_src, r, c, v, k, ro, co, vo, ko
    "nmf_gather3k": ([_I64, _i64, _I64, _i32, _i32, _f32, _i64, _i32, _i32, _f32,
                      _i64], _I64),
    # ntiles, t_first, counts, base, s_rows, s_cols, s_vals, nnz, cwidth,
    # coords, vals, n_slots, slot_out
    "nmf_chunk_fill": ([_I64, _i64, _i64, _i64, _i32, _i32, _f32, _I64, _I64, _i32,
                        _f32, _I64, _i64], _I64),
    # ntiles, t_first, counts, dst, a_rows, a_cols, a_vals, order, n, ro, co,
    # vo, oo
    "nmf_class_extract": ([_I64, _i64, _i64, _i64, _i32, _i32, _f32, _i64, _I64,
                           _i32, _i32, _f32, _i64], _I64),
}


def _compiler() -> str:
    for name in CXX:
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(
        f"no host C++ compiler ({' or '.join(CXX)}) found: the host library "
        f"is built from {SOURCE.name} at first use"
    )


def _build(target: Path) -> None:
    cxx = _compiler()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = BUILD / f"{target.stem}.{os.getpid()}.so"
    run = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if run.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{run.stdout}")
    os.replace(tmp, target)  # atomic: a concurrent process loads a whole file


def load():
    """The host library (built on first call), with ``argtypes`` and
    ``restype`` set on every entry point.  Recorded as the spans
    ``native.load`` and, around a build, ``native.build``."""
    global _lib
    if _lib is not None:
        return _lib
    with spans.span("native.load"):
        h = hashlib.sha256(SOURCE.read_bytes())
        h.update(" ".join(CXX_FLAGS).encode())
        target = BUILD / f"libnmf_host_{h.hexdigest()[:16]}.so"
        if not target.exists():
            with spans.span("native.build"):
                _build(target)
        lib = ctypes.CDLL(str(target))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return lib
