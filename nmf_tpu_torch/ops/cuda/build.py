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
import time
from pathlib import Path

__all__ = ["load_kernels", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("chunk_matmul.cu", "dense_matmul.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # panel_ptr, panel_chunks, win_panel, coords, vals, D, out,
    # n_rowpanels, group, rows, k, stream
    "nmf_chunk_matmul": [_P] * 7 + [_I] * 4 + [_P],
    # dpanel_ptr, dpanel_blocks, dblk_panel, dvals, D, out,
    # n_rowpanels, dgroup, rows, cols, k, stream
    "nmf_dense_matmul": [_P] * 6 + [_I] * 5 + [_P],
}

_lib = None
build_seconds = None  # seconds the last build in this process took, if any


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
    and ``restype`` set on every entry point."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((CSRC / s).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD / f"libnmf_kernels_{h.hexdigest()[:16]}.so"
    if not target.exists():
        t0 = time.perf_counter()
        _build(target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
