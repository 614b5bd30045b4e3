#!/usr/bin/env python3
"""Time variants of the divergence products (kernels 8 and 9, ``wtq`` and
``qht`` in ``nmf_tpu_torch/csrc/mu.cu``) against the source as it stands, on
the dense 100,000 x 10,000 rank-64 problem of ``chip_smoke.py``.

    python3 tools/time_quotient_variants.py [NAME ...]

Each variant is ``mu.cu`` with a few lines replaced (``VARIANTS`` below; a
replaced line must be in the source, or the tool fails), built into
``_cache/`` (ignored by git), all variants' ``nvcc`` started together.
``no_range_check`` drops the check that sends an operand outside the
branch-free division's range to '/' (it says what the check costs);
``slash_division`` divides with '/' itself, so its output must have the same
bits as the source's.  For each variant and kernel: ms (ten launches in a row
after an L2 flush, median of 3, the walk cut as the wrapper cuts it), the
highest SM clock nvidia-smi reads meanwhile (every 20 ms), the error against the plain
version run in float64, whether two runs give the same bits and whether they
are the source's, and the registers, spills and barriers ``ptxas`` reports
for the k <= 64 instance.  Prints one JSON line with the card's name and
power limit."""

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nmf_tpu_torch.ops.cuda import build  # noqa: E402
from nmf_tpu_torch.ops.cuda import mu as M  # noqa: E402
from nmf_tpu_torch.utils.dtypes import sqrt_eps  # noqa: E402

_DIV = ("      x.x = div_rn(x.x, wh[u][4 * h] + delta, ok);\n"
        "      x.y = div_rn(x.y, wh[u][4 * h + 1] + delta, ok);\n"
        "      x.z = div_rn(x.z, wh[u][4 * h + 2] + delta, ok);\n"
        "      x.w = div_rn(x.w, wh[u][4 * h + 3] + delta, ok);\n")
_SLASH = ("      x.x = x.x / (wh[u][4 * h] + delta);\n"
          "      x.y = x.y / (wh[u][4 * h + 1] + delta);\n"
          "      x.z = x.z / (wh[u][4 * h + 2] + delta);\n"
          "      x.w = x.w / (wh[u][4 * h + 3] + delta);\n")
_CHECK = ("  ok &= (ay >= 0x1p-64f) & (ay <= 0x1p64f) & (ax <= 0x1p64f) &\n"
          "        ((ax >= 0x1p-64f) | (x == 0.f));\n")
_WTQ_SECOND = "    piece_outer<Slab, Wide>(acc, Wc, ty, 8 + ty, Xb, tx, 32 + tx, QT_S);\n"
_WTQ_WH = "      piece_rows<Slab, Wide>(wh, Wc, ty, Hs, tx, 32 + tx, QT_KS);\n"
_QHT_WH = "      piece_outer<WideT, Slab>(wh, Wt, ty, 32 + ty, Hc, tx, 8 + tx, QT_KS);\n"
_QHT_SECOND = ("          acc[u][v] = fmaf(xq[u].x, hq[v].x, acc[u][v]);\n"
               "          acc[u][v] = fmaf(xq[u].y, hq[v].y, acc[u][v]);\n"
               "          acc[u][v] = fmaf(xq[u].z, hq[v].z, acc[u][v]);\n"
               "          acc[u][v] = fmaf(xq[u].w, hq[v].w, acc[u][v]);\n")
_OUTER_LOOP = "#pragma unroll 16\n  for (int t = 0; t < depth; ++t) {\n"
_QHT_LOOP = "#pragma unroll 2\n    for (int q = 0; q < QT_S / 4; ++q) {  // acc += Q[..][j] H[c0..][j0 + j]'\n"
_ROWS_LOOP = "#pragma unroll 2\n  for (int q = 0; q < depth / 4; ++q) {\n"

# name: [(text in mu.cu, its replacement), ...]
VARIANTS = {
    # the division as '/' writes it: a branch after each; the same bits
    "slash_division": [(_DIV, _SLASH)],
    # where the time goes: no division (a product), no second product, no
    # W @ H tile (each changes the result)
    "no_division": [(_DIV, _SLASH.replace(" / (", " * ("))],
    "no_second": [(_WTQ_SECOND, ""), (_QHT_SECOND, "          {}\n")],
    "no_wh": [(_WTQ_WH, ""), (_QHT_WH, "")],
    # the branch-free division without its range check (what the check costs)
    "no_range_check": [(_CHECK, "")],
    # outer products (wtq's second product, qht's W @ H tile) unrolled by 4
    # or 8 (the source: 16); wtq's W @ H tile by 1 or 4 (the source: 2);
    # qht's second product by 1 (the source: 2)
    "outer_unroll_4": [(_OUTER_LOOP, _OUTER_LOOP.replace("unroll 16", "unroll 4"))],
    "outer_unroll_8": [(_OUTER_LOOP, _OUTER_LOOP.replace("unroll 16", "unroll 8"))],
    "rows_unroll_1": [(_ROWS_LOOP, _ROWS_LOOP.replace("unroll 2", "unroll 1"))],
    "rows_unroll_4": [(_ROWS_LOOP, _ROWS_LOOP.replace("unroll 2", "unroll 4"))],
    "qht_second_unroll_1": [(_QHT_LOOP, _QHT_LOOP.replace("unroll 2", "unroll 1"))],
}


def _build(name, edits):
    """Starts nvcc on ``mu.cu`` with ``edits``; returns (process, .so path)."""
    text = (build.CSRC / "mu.cu").read_text()
    for old, new in edits:
        if old not in text:
            cs.fail(f"variant {name}: a replaced line is not in mu.cu:\n{old}")
        text = text.replace(old, new)
    src = ROOT / "_cache" / f"mu_{name}.cu"
    src.parent.mkdir(exist_ok=True)
    src.write_text(text)
    so = src.with_suffix(".so")
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I",
         str(build.CSRC), str(src), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def _ptxas(log):
    """Registers, spill bytes and barriers of each k <= 64 instance."""
    out = {}
    for kern in ("wtq", "qht"):
        m = re.search(rf"Compiling entry function '\S*{kern}_kernelILb1E\S*'.*?\n"
                      r".*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads\n.*?Used (\d+) registers, used (\d+) barriers",
                      log)
        if m:
            out[kern] = {"registers": int(m[4]), "spill_stores": int(m[2]),
                         "spill_loads": int(m[3]), "barriers": int(m[5])}
    return out


def _entry(so, name):
    fn = getattr(ctypes.CDLL(str(so)), f"nmf_{name}")
    fn.argtypes = build._ARGTYPES[f"nmf_{name}"]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    names = sys.argv[1:] or list(VARIANTS)
    builds = {n: _build(n, VARIANTS[n]) for n in names}
    rng = np.random.default_rng(0)
    X = cs._lowrank_noisy_on_card(rng, cs.DP, cs.DN, cs.DK)
    W = torch.from_numpy(rng.random((cs.DP, cs.DK), dtype=np.float32)).cuda()
    H = torch.from_numpy(rng.random((cs.DK, cs.DN), dtype=np.float32)).cuda()
    p, n, k = cs.DP, cs.DN, cs.DK
    delta = sqrt_eps(torch.float32)
    build.load_kernels()
    own_log = sorted(build.BUILD.glob("*.log"))[-1].read_text()
    libs, ptxas = {"own": None}, {"own": _ptxas(own_log)}
    for name, (proc, so) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:  # reported, and the others timed
            ptxas[name] = {"build_error": log[-2000:]}
            continue
        libs[name], ptxas[name] = so, _ptxas(log)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"shape": [p, n], "k": k, "ms": {}, "rel_err": {}, "same_bits": {},
           "same_bits_as_own": {}, "sm_mhz": {}, "ptxas": ptxas}
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    for kern, plain, shape, owned, walked in (("wtq", M.wtq_plain, (k, n), n, p),
                                              ("qht", M.qht_plain, (p, k), p, n)):
        want = plain(Xd, Wd, Hd, delta)
        splits = M.walk_splits(owned, walked, k, sms, M.QT_EDGE)
        res = torch.empty(shape, device="cuda")
        part = torch.empty((splits, *shape), device="cuda")
        xvec = M.check_dense_problem(X, W, H, kern)[5]
        for name, so in libs.items():
            if so is None:
                run = lambda kern=kern: getattr(M, kern)(X, W, H, delta)  # noqa: E731
            else:
                fn = _entry(so, kern)

                def run(fn=fn):
                    err = fn(X.data_ptr(), W.data_ptr(), H.data_ptr(), part.data_ptr(),
                             res.data_ptr(), p, n, k, delta, xvec, splits,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                    return res
            got = run().clone()
            torch.cuda.synchronize()
            key = f"{name}_{kern}"
            if so is None:
                own = got
            else:
                out["same_bits_as_own"][key] = bool(torch.equal(got, own))
            out["rel_err"][key] = float((got.double() - want).abs().max() / want.abs().max())
            out["same_bits"][key] = bool(torch.equal(got, run()))
            smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                 "-lms", "20"], stdout=subprocess.PIPE, text=True)
            out["ms"][key] = cs.time_ms(lambda: [run() for _ in range(10)], reps=3) / 10
            smi.terminate()
            mhz = [int(v) for v in smi.communicate()[0].split() if v.isdigit()]
            out["sm_mhz"][key] = max(mhz) if mhz else None
        del want, own
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
