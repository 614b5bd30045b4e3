#!/usr/bin/env python3
"""Time where the dense-tile product (kernel 2, ``dense_matmul``) splits its
operands for the 3xTF32 tensor-core passes:

* ``in_registers`` — the product's own route: each fragment element split as
  it is read from shared memory (``nmf_tpu_torch/csrc/dense_matmul.cu``);
* ``at_staging`` — each element split once, after its copy lands, into
  (hi, lo) pairs in shared memory (``tools/dense_split_at_staging.cu``);
* ``one_pass`` — the product's own source with the two small passes left
  out: one TF32 pass, the time the split's arithmetic leaves to the rest
  (its error is the single pass's, far above the tolerance).

    python3 tools/time_dense_split.py

Builds the two variants into ``_cache/`` (ignored by git), makes or reuses
the 163,000 x 59,000 matrix of ``chip_smoke.py`` there (seed 0, k 128),
builds it as the chunk store and times each route on both sides: L2 flushed,
median of 5, with the error against the plain version run in float64 and
whether two runs give the same bits.  Prints one JSON line with the card's
name and power limit."""

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from nmf_tpu_torch.ops import sparse_format as sf  # noqa: E402
from nmf_tpu_torch.ops.cuda import build, sparse as S  # noqa: E402
from time_sparse_kernels import _matrix  # noqa: E402

SMALL_PASSES = (
    "        for (int ni = 0; ni < 4; ++ni) mma(blk[mi][ni], al[mi], bh[ni]);",
    "        for (int ni = 0; ni < 4; ++ni) mma(blk[mi][ni], ah[mi], bl[ni]);",
)


def _variant(name, text, entry):
    """``text`` built into ``_cache/<name>.so``; its entry point ``entry``
    (the arguments of ``nmf_dense_matmul``)."""
    src = ROOT / "_cache" / f"{name}.cu"
    so = src.with_suffix(".so")
    src.parent.mkdir(exist_ok=True)
    src.write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC),
                    str(src), "-o", str(so)], check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _caller(fn, side, D):
    out = torch.zeros((side.rows, D.shape[1]), device="cuda")
    parts = torch.empty((side.n_dparts, sf.TILE, D.shape[1]), device="cuda")
    args = [side.dpiece_ptr, side.dpiece_panel, side.dpiece_part, side.dsplit_ptr,
            side.dsplit_panel, side.dpanel_blocks, side.dblk_panel, side.dvals, D,
            out, parts]

    def run():
        out.zero_()
        err = fn(*[a.data_ptr() for a in args], side.dpiece_panel.numel(),
                 side.dsplit_panel.numel(), sf.DENSE_GROUP, side.rows, side.cols,
                 D.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    own = (build.CSRC / "dense_matmul.cu").read_text()
    if not all(p in own for p in SMALL_PASSES):
        cs.fail("the product's source no longer has the two small passes")
    one = own.replace('extern "C" int nmf_dense_matmul(', 'extern "C" int x_dense_one_pass(')
    for p in SMALL_PASSES:
        one = one.replace(p, "        for (int ni = 0; ni < 4; ++ni) {}")
    variants = {
        "at_staging": _variant("dense_split_at_staging",
                               (ROOT / "tools" / "dense_split_at_staging.cu").read_text(),
                               "x_dense_staged"),
        "one_pass": _variant("dense_one_pass", one, "x_dense_one_pass"),
    }
    rows, cols, vals = _matrix(cs)
    X = sf.build_tiled(rows, cols, vals, (cs.P, cs.N), dense_tile_nnz=192, coo_tail_nnz=3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"k": cs.K, "cap_blocks": sf.DENSE_PIECE_BLOCKS, "ms": {}, "rel_err": {},
           "same_bits": {}}
    for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
        D = torch.rand((side.cols, cs.K), generator=gen, device="cuda")
        want = S.dense_matmul_plain(side, D.double())
        runs = {"in_registers": lambda: S.dense_matmul(side, D)}
        runs.update({name: _caller(fn, side, D) for name, fn in variants.items()})
        for name, run in runs.items():
            key = f"{name}_{sname}"
            got = run().clone()
            torch.cuda.synchronize()
            out["rel_err"][key] = float((got.double() - want).abs().max()
                                        / want.abs().max())
            out["same_bits"][key] = bool(torch.equal(got, run()))
            out["ms"][key] = cs.time_ms(run)
        del want
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
