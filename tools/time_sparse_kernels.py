#!/usr/bin/env python3
"""Time the product kernels over the tiled store (``chunk_matmul``,
``dense_matmul``, ``quad_matmul`` and the band's ``coo_matmul``) of one
checkout of the PyTorch build, so that two checkouts can be compared on one
card in one run.

    python3 tools/time_sparse_kernels.py [TREE]

``TREE`` is the root of a checkout (default: this one); its
``nmf_tpu_torch`` package and its ``chip_smoke`` helpers are imported, its
kernels built, and each kernel timed on both sides of the 163,000 x 59,000
power-law matrix of ``chip_smoke.py`` (seed 0, k 128), built by the tree's own
``build_tiled`` as the chunk store and as the quad-tail store: L2 flushed,
median of 5, beside one ``torch.sparse.mm`` on the same entries (the band
adds into one output tensor a call).  A tree that cuts panels into pieces
also reports its pieces and the kernels' times at other piece caps (for the
dense kernel: blocks a piece, where the tree cuts its dense lists).  The matrix is made once and kept in ``_cache/`` beside
this script's checkout (ignored by git), so that runs in turns share it.
Prints one JSON line with the card's name and power limit.  Run two trees in
turns (A, B, B, A) in one call to compare them."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAPS = (512, 1024, 4096, 8192)  # piece caps tried beside the store's own
DCAPS = (4, 8, 16, 32, 64)  # dense blocks a piece


def _matrix(cs):
    path = ROOT / "_cache" / "ttt4_coo.npz"
    if path.exists():
        with np.load(path) as z:
            return z["rows"], z["cols"], z["vals"]
    rows, cols, vals = cs._movielens_like(np.random.default_rng(0))
    path.parent.mkdir(exist_ok=True)
    np.savez(path, rows=rows, cols=cols, vals=vals)
    return rows, cols, vals


def main():
    tree = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from nmf_tpu_torch.ops import sparse_format as sf
    from nmf_tpu_torch.ops.cuda import sparse as S

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    rows, cols, vals = _matrix(cs)
    out = {"tree": str(tree), "k": cs.K, "ms": {}, "library_ms": {},
           "balance": {}, "ms_by_cap": {}}
    for store, opts, quad in (
            ("chunk", dict(dense_tile_nnz=192, coo_tail_nnz=3), False),
            ("quad", dict(dense_tile_nnz=192, quad_tail_nnz=32), True)):
        X = sf.build_tiled(rows, cols, vals, (cs.P, cs.N), **opts)
        kern = S.quad_matmul if quad else S.chunk_matmul
        name = "quad_matmul" if quad else "chunk_matmul"
        gen = torch.Generator(device="cuda").manual_seed(1)
        for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
            D = torch.rand((side.cols, cs.K), generator=gen, device="cuda")
            key = f"{name}_{sname}"
            out["ms"][key] = cs.time_ms(lambda: kern(side, D))
            A, _ = cs._class_csr(side, store)
            out["library_ms"][key] = cs.time_ms(lambda: torch.sparse.mm(A, D))
            del A
            # a tree without pieces has no balance to report
            out["balance"][key] = cs.balance(side, store) if hasattr(cs, "balance") else None
            if hasattr(sf, "recut_pieces"):
                by = {}
                for cap in CAPS:
                    cut = sf.recut_pieces(side, None if quad else cap, cap if quad else None)
                    by[cap] = cs.time_ms(lambda: kern(cut, D))
                out["ms_by_cap"][key] = by
            if quad:
                continue
            # the dense blocks and the band of the chunk store
            key = f"dense_matmul_{sname}"
            out["ms"][key] = cs.time_ms(lambda: S.dense_matmul(side, D))
            A, _ = cs._class_csr(side, "dense")
            out["library_ms"][key] = cs.time_ms(lambda: torch.sparse.mm(A, D))
            del A
            if hasattr(sf, "DENSE_PIECE_BLOCKS"):
                out["balance"][key] = {"pieces": side.dpiece_panel.numel(),
                                       "split_panels": side.dsplit_panel.numel(),
                                       "cap": sf.DENSE_PIECE_BLOCKS}
                by = {}
                for cap in DCAPS:
                    cut = sf.recut_pieces(side, dcap=cap)
                    by[cap] = cs.time_ms(lambda: S.dense_matmul(cut, D))
                out["ms_by_cap"][key] = by
            key = f"coo_matmul_{sname}"
            acc = torch.zeros((side.rows, cs.K), device="cuda")
            out["ms"][key] = cs.time_ms(lambda: S.coo_matmul(side, D, acc))
            rc = torch.stack([side.coo_rows.long(), side.coo_cols.long()])
            A = torch.sparse_coo_tensor(rc, side.coo_vals, (side.rows, side.cols)
                                        ).coalesce().to_sparse_csr()
            out["library_ms"][key] = cs.time_ms(lambda: torch.sparse.mm(A, D))
            del A, acc
        del X
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
