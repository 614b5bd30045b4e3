"""Build and load the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they are
compiled with ``nvcc`` for ``sm_90a`` — one compiler process per source, all
started together — linked into one shared library inside the package's
``build/`` directory (ignored by git), and loaded with ``ctypes``.  The
library's name carries a hash of the sources, so an edited source is rebuilt
and an unchanged one is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ...utils import spans

__all__ = ["load_kernels", "launch", "launch_counts", "reset_launch_counts",
           "KERNELS", "NVCC_FLAGS", "SMEM_PER_BLOCK"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = (
    "chunk_matmul.cu", "dense_matmul.cu", "quad_matmul.cu", "coo_matmul.cu",
    "csr_matmul.cu", "chunk_sddmm.cu", "quad_sddmm.cu", "mu.cu", "objectives.cu",
    "elementwise.cu", "hals.cu",
)
# quotient_tile.cuh: mu.cu and objectives.cu; sddmm_piece.cuh: the two
# sampled products (chunk_sddmm.cu, quad_sddmm.cu); piece_walk.cuh: the chunk
# and quad products; piece_combine.cuh: those two and the dense product;
# cp_async.cuh: the dense product, sddmm_piece.cuh, quotient_tile.cuh and
# the HALS sweep (hals.cu)
HEADERS = ("quotient_tile.cuh", "sddmm_piece.cuh", "piece_walk.cuh",
           "piece_combine.cuh", "cp_async.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

SMEM_PER_BLOCK = 232448  # bytes of shared memory one thread block may use

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.c_size_t
_L = ctypes.c_longlong
_ARGTYPES = {
    # piece_ptr, piece_panel, piece_part, split_ptr, split_panel,
    # panel_chunks, chunk_nreal, win_panel, coords, vals, D, out, parts,
    # n_pieces, n_split, group, span, rows, k, stream
    "nmf_chunk_matmul": [_P] * 13 + [_I] * 6 + [_P],
    # dpiece_ptr, dpiece_panel, dpiece_part, dsplit_ptr, dsplit_panel,
    # dpanel_blocks, dblk_panel, dvals, D, out, parts,
    # n_pieces, n_split, dgroup, rows, cols, k, stream
    "nmf_dense_matmul": [_P] * 11 + [_I] * 6 + [_P],
    # qpiece_ptr, qpiece_panel, qpiece_part, qsplit_ptr, qsplit_panel,
    # qpanel_segs, qseg_nreal, qwin_panel, qlrows, qlcols, qvals, D, out,
    # parts, n_pieces, n_split, qgroup, seg, rows, k, stream
    "nmf_quad_matmul": [_P] * 14 + [_I] * 6 + [_P],
    # coo_ptr, coo_cols, coo_vals, D, out, rows, k, stream
    "nmf_coo_matmul": [_P] * 5 + [_I] * 2 + [_P],
    # piece_ptr, piece_row, piece_part, split_ptr, split_row, cols, vals, D,
    # out, parts, n_pieces, n_split, k, slab, stream_loads, stream
    "nmf_csr_matmul": [_P] * 10 + [_I] * 5 + [_P],
    # piece_ptr, piece_panel, panel_chunks, chunk_nreal, win_panel, coords,
    # inv, W, Ht, out, n_pieces, n_chunks, group, span, rows, cols, k, nnz,
    # lanes, stream
    "nmf_chunk_sddmm": [_P] * 10 + [_I] * 9 + [_P],
    # qpiece_ptr, qpiece_panel, qpanel_segs, qseg_nreal, qwin_panel, qlrows,
    # qlcols, qinv, W, Ht, out, n_pieces, n_qchunks, qgroup, seg, rows, cols,
    # k, nnz, lanes, stream
    "nmf_quad_sddmm": [_P] * 11 + [_I] * 9 + [_P],
    # F, G, C, out, k, m, lam, delta, trans, bn, blocks, stream
    "nmf_mu_factor_update": [_P] * 4 + [_I] * 2 + [_F] * 2 + [_I] * 3 + [_P],
    # X, W, H, partial, out, p, n, k, delta, xvec, splits, stream
    "nmf_wtq": [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P],
    "nmf_qht": [_P] * 5 + [_I] * 3 + [_F, _I, _I, _P],
    # X, W, H, partial, out, p, n, k, kind, xvec, splits, stream
    "nmf_dense_objective": [_P] * 5 + [_I] * 6 + [_P],
    # A, out, count, vec, stream
    "nmf_projectnn": [_P, _P, _S, _I, _P],
    # A, scratch, out, m, n, blocks, rows, vec, stream
    "nmf_colsum": [_P] * 3 + [_I] * 5 + [_P],
    # A, sums, out, count, n, vec, stream
    "nmf_scale_cols": [_P] * 3 + [_S, _I, _I, _P],
    # W, G, C, perm, m, rows, k, W's and C's strides (lane, row, column),
    # stream
    "nmf_hals_sweep": [_P] * 4 + [_I] * 3 + [_L] * 6 + [_P],
}

# one entry point ``nmf_<name>`` and one launch count per kernel
KERNELS = tuple(name[len("nmf_"):] for name in _ARGTYPES)
_launches = dict.fromkeys(KERNELS, 0)

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    objs = [BUILD / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(SOURCES, procs, logs):
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {s}:\n{log}")
    tmp = BUILD / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc failed to link the kernels:\n{link.stdout}")
    (BUILD / f"{target.stem}.log").write_text("\n".join(logs))
    os.replace(tmp, target)  # atomic: a concurrent process loads a whole file
    for o in objs:
        o.unlink()


def load_kernels():
    """The kernels' shared library (built on first call), with ``argtypes``
    and ``restype`` set on every entry point.  Recorded as the spans
    ``kernels.load`` and, around a build, ``kernels.build``."""
    global _lib
    if _lib is not None:
        return _lib
    with spans.span("kernels.load"):
        h = hashlib.sha256()
        for s in SOURCES + HEADERS:
            h.update((CSRC / s).read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        target = BUILD / f"libnmf_kernels_{h.hexdigest()[:16]}.so"
        if not target.exists():
            with spans.span("kernels.build"):
                _build(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return lib


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` and count the launch (also in the innermost
    span while ``utils.spans`` records); raises when the launch is refused.
    The only place a count moves.  A tensor argument is passed
    as its data pointer; the kernel runs on the device of the first one, on
    that device's current stream, under a device guard."""
    fn = getattr(load_kernels(), f"nmf_{name}")
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")
    _launches[name] += 1
    spans.launched()


def launch_counts() -> dict:
    """Kernel launches so far, by kernel name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
