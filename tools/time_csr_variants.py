#!/usr/bin/env python3
"""Time variants of the general-CSR kernel (``csrc/csr_matmul.cu``) on one
card: the same source built with other ``GROUP`` (gathers a warp issues
before its first add waits on one) and ``WARPS`` (warps a block), each into
its own library under ``_cache/`` (ignored by git), all ``nvcc`` processes
started together.

    python3 tools/time_csr_variants.py [NAME ...]

Each variant runs over both orientations of the ttt4 matrix of
``chip_smoke.py`` (seed 0, 163,000 x 59,000, k 128) as the port's
``SparseCSR``, with the package's piece cap and its own choice of loads, one
column slab: L2 flushed, median of 5 (``chip_smoke.time_ms``), beside the
package's build and one ``torch.sparse.mm`` on the same CSR arrays.  The
variants change no bit (a variant that does fails the run).  Prints one JSON
line with the card's name and power limit."""

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = {
    "g8_w4": dict(GROUP=8, WARPS=4),  # the package's
    "g4_w4": dict(GROUP=4, WARPS=4),
    "g16_w4": dict(GROUP=16, WARPS=4),
    "g8_w2": dict(GROUP=8, WARPS=2),
    "g8_w8": dict(GROUP=8, WARPS=8),  # the first design
    "g4_w8": dict(GROUP=4, WARPS=8),
    "g8_w16": dict(GROUP=8, WARPS=16),
}


def _matrix(cs):
    path = ROOT / "_cache" / "ttt4_coo.npz"
    if path.exists():
        with np.load(path) as z:
            return z["rows"], z["cols"], z["vals"]
    rows, cols, vals = cs._movielens_like(np.random.default_rng(0))
    path.parent.mkdir(exist_ok=True)
    np.savez(path, rows=rows, cols=cols, vals=vals)
    return rows, cols, vals


def _build(names):
    from nmf_tpu_torch.ops.cuda import build

    out = ROOT / "_cache"
    out.mkdir(exist_ok=True)
    src = build.CSRC / "csr_matmul.cu"
    procs = {}
    for name in names:
        defs = [f"-D{k}={v}" for k, v in VARIANTS[name].items()]
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", *defs, str(src), "-o",
             str(out / f"csr_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"csr_{name}.so")).nmf_csr_matmul
        fn.argtypes = build._ARGTYPES["nmf_csr_matmul"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    import chip_smoke as cs
    from nmf_tpu_torch.ops.cuda import sparse as S

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = _build(names)
    rows, cols, vals = _matrix(cs)
    _, A, _ = cs.general_csr(rows, cols, vals)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rec = {"card": smi, "k": cs.K, "ms": {}, "library_ms": {}, "package_ms": {}}
    for sname, side in (("fwd", A.fwd), ("bwd", A.bwd)):
        D = torch.rand((side.cols, cs.K), generator=gen, device="cuda")
        ref = S.csr_matmul(side, D)
        rec["package_ms"][sname] = cs.time_ms(lambda: S.csr_matmul(side, D))
        lib_x = torch.sparse_csr_tensor(side.crow, side.col, side.val,
                                        (side.rows, side.cols))
        rec["library_ms"][sname] = cs.time_ms(lambda: torch.sparse.mm(lib_x, D))
        stream = torch.cuda.current_stream().cuda_stream

        def run(fn):
            out = torch.empty_like(ref)
            parts = torch.empty((side.n_parts, cs.K), device="cuda")
            err = fn(side.piece_ptr.data_ptr(), side.piece_row.data_ptr(),
                     side.piece_part.data_ptr(), side.split_ptr.data_ptr(),
                     side.split_row.data_ptr(), side.col.data_ptr(), side.val.data_ptr(),
                     D.data_ptr(), out.data_ptr(), parts.data_ptr(),
                     side.piece_row.numel(), side.split_row.numel(), cs.K, cs.K,
                     int(S.CSR_STREAM_LOADS), stream)
            if err:
                cs.fail(f"variant failed to launch: CUDA error {err}")
            return out

        for name, fn in libs.items():
            got = run(fn)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                cs.fail(f"variant {name} {sname}: other bits than the package's build")
            rec["ms"].setdefault(name, {})[sname] = cs.time_ms(lambda: run(fn))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
