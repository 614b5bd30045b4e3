#!/usr/bin/env python3
"""Time variants of the kernels built on the W @ H tile routine
(``nmf_tpu_torch/csrc/quotient_tile.cuh``): the divergence products (kernels
8 and 9, ``wtq`` and ``qht`` in ``mu.cu``) and the dense objectives (kernel
6, ``objectives.cu``, both kinds), and of the MSE factor step beside them
(kernel 7, ``mu_factor_update`` in ``mu.cu``, its H and W steps), against
the sources as they stand, on the dense 100,000 x 10,000 rank-64 problem of
``chip_smoke.py``.

    python3 tools/time_quotient_variants.py [NAME ...]

Each variant is the sources with a few lines replaced (``VARIANTS`` below; a
replaced line must be in ``mu.cu``, ``objectives.cu`` or the header, or the
tool fails), copied into ``_cache/variants/NAME/`` (ignored by git) and
built there, all variants' ``nvcc`` started together; a variant times the
kernels its edits reach.
``no_range_check`` drops the check that sends an operand outside the
branch-free division's range to '/' (it says what the check costs);
``slash_division`` divides with '/' itself, so its output must have the same
bits as the source's.  For each variant and kernel: ms (ten launches in a row
after an L2 flush, median of 3, the walk cut as the wrapper cuts it), the
highest SM clock nvidia-smi reads meanwhile (every 20 ms), the error against the plain
version run in float64, whether two runs give the same bits and whether they
are the source's, and the registers, spills and barriers ``ptxas`` reports
for the k <= 64 instances.  Kernel 7 as the sources stand is also timed
at other grids (``mu_ms_by_grid``: tile width and blocks), by
``chip_smoke.time_ms`` (one launch after the L2 flush, which leaves the
flush's last 50 MB dirty in L2), after a flush that only reads (``clean``:
nothing to write back) and by its device time alone (``graph``: 100
launches as one CUDA graph, replayed).  Prints one JSON line with the
card's name and power limit."""

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
from nmf_tpu_torch.ops.cuda import objectives as O  # noqa: E402
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

_STEP_F = "__device__ __forceinline__ float step_terms("
_STEP_T = "  float t = 0.f, t1 = 0.f;\n#pragma unroll\n  for (int u = 0; u < 8; ++u)\n"
_STEP_SUM = "    const float t = step_terms<KIND, RATIO>(Xb, wh, ty, tx);\n"
_FAST_WALK = "  double s = walk<ONE, KIND, KIND == 1>("
_RATIO_LOG = "    const float l = logf(div_rn(a, y, unused));\n"
_TERM_BODY = "  if (KIND == 0) {\n    const float d = x - w;\n"

QUOTIENTS = ("wtq", "qht")
OBJECTIVES = ("objective_mse", "objective_kl")
FACTOR = ("mu_factor_update_H", "mu_factor_update_W")
_MU_DIV = "      for (int c = 0; c < 4; ++c) o[a][c] = div_rn(num(a, c), den(a, c), ok);\n"
_MU_FMA = ("          mu_fma<TRANS, BN>(acc, Gs, Fb, ld, q * MU_RC, min(k, (q + 1) * MU_RC), "
           "tx, ty);\n")
_MU_READY = "    if (dev < 32) ready |= 1u << dev;\n  }\n  const int ks = k < MU_KS"
_MU_NQ = "#define MU_NQ 2 "
_MU_ST = ("      if (vec && i + 3 < ni) {\n"
          "        st4(dst, make_float4(o[0][c], o[1][c], o[2][c], o[3][c]));\n"
          "      } else {\n"
          "        for (int a = 0; a < 4 && i + a < ni; ++a) dst[a] = o[a][c];\n"
          "      }\n")
_MU_PREFETCH = "          if (next < tiles) {\n            stage_unit("
_MU_UNROLL = "#pragma unroll 2\n  for (int r = rb; r < nr4; r += 4) {\n"
_MU_GLDS = "    for (int a = 0; a < 4; ++a) g[a] = ld4(g0 + a * ld + r);\n"
_MU_FLDS = ("      f[c] = TRANS ? ld4(Fs + (tx + BN / 4 * c) * ld + r) : "
            "ld4(Fs + (r + c) * BN + 4 * tx);\n")
# name: (the kernels it times, [(text in a source, its replacement), ...])
VARIANTS = {
    # the division as '/' writes it: a branch after each; the same bits
    "slash_division": (QUOTIENTS, [(_DIV, _SLASH)]),
    # where the time goes: no division (a product), no second product, no
    # W @ H tile (each changes the result)
    "no_division": (QUOTIENTS, [(_DIV, _SLASH.replace(" / (", " * ("))]),
    "no_second": (QUOTIENTS, [(_WTQ_SECOND, ""), (_QHT_SECOND, "          {}\n")]),
    "no_wh": (QUOTIENTS, [(_WTQ_WH, ""), (_QHT_WH, "")]),
    # the branch-free division without its range check (what the check costs)
    "no_range_check": (QUOTIENTS, [(_CHECK, "")]),
    # outer products (wtq's second product, qht's W @ H tile) unrolled by 4
    # or 8 (the source: 16); the W @ H tile of wtq and the objective by 1 or
    # 4 (the source: 2); qht's second product by 1 (the source: 2)
    "outer_unroll_4": (QUOTIENTS, [(_OUTER_LOOP, _OUTER_LOOP.replace("unroll 16", "unroll 4"))]),
    "outer_unroll_8": (QUOTIENTS, [(_OUTER_LOOP, _OUTER_LOOP.replace("unroll 16", "unroll 8"))]),
    "rows_unroll_1": (QUOTIENTS + OBJECTIVES,
                      [(_ROWS_LOOP, _ROWS_LOOP.replace("unroll 2", "unroll 1"))]),
    "rows_unroll_4": (QUOTIENTS + OBJECTIVES,
                      [(_ROWS_LOOP, _ROWS_LOOP.replace("unroll 2", "unroll 4"))]),
    "qht_second_unroll_1": (QUOTIENTS, [(_QHT_LOOP, _QHT_LOOP.replace("unroll 2", "unroll 1"))]),
    # the objective: each term added to a double (the source: a step's 64
    # terms summed in float32 first); the KL term as log x - log wh (two
    # logf; the source: one logf of x / wh, the division by div_rn), or with
    # the division by '/'; the step's terms in one running sum (the source:
    # two); without logf, which says what the logarithms cost; no term at
    # all (x + wh summed), which says what the terms cost over the W @ H
    # tile and its staging
    "objective_double_per_entry": (OBJECTIVES, [
        (_STEP_F, _STEP_F.replace("float", "double")),
        (_STEP_T, _STEP_T.replace("float t = 0.f, t1 = 0.f", "double t = 0.0, t1 = 0.0")),
        (_STEP_SUM, _STEP_SUM.replace("const float t", "const double t"))]),
    "objective_two_logs": (OBJECTIVES, [(_FAST_WALK, "  double s = walk<ONE, KIND, false>(")]),
    "objective_ratio_slash": (OBJECTIVES, [(_RATIO_LOG, "    const float l = logf(a / y);\n")]),
    "objective_one_sum": (OBJECTIVES, [
        (_STEP_T, _STEP_T.replace("float t = 0.f, t1 = 0.f", "float t = 0.f")),
        ("      t1 += term<KIND, RATIO>(x.z", "      t += term<KIND, RATIO>(x.z"),
        ("      t1 += term<KIND, RATIO>(x.w", "      t += term<KIND, RATIO>(x.w"),
        ("  return t + t1;\n", "  return t;\n")]),
    "objective_no_log": (OBJECTIVES, [("logf(", "(")]),
    "objective_no_term": (OBJECTIVES, [(_TERM_BODY, "  return x + w;\n" + _TERM_BODY)]),
    # kernel 7: the epilogue's division by '/' (the same bits); no FMA (the
    # loads, the epilogue and the stores alone; changes the result); the
    # shared-memory carveout asked at its largest
    "mu_slash": (FACTOR, [(_MU_DIV, _MU_DIV.replace("div_rn(num(a, c), den(a, c), ok)",
                                                    "num(a, c) / den(a, c)"))]),
    "mu_no_fma": (FACTOR, [(_MU_FMA, "")]),
    # the G or the F tile's shared loads replaced by constants (the FMA
    # stay; change the result): what the shared loads cost
    "mu_no_g_lds": (FACTOR, [(_MU_GLDS, _MU_GLDS.replace("ld4(g0 + a * ld + r)",
                                                         "make_float4(1.f, 1.f, 1.f, 1.f)"))]),
    "mu_no_f_lds": (FACTOR, [(_MU_FLDS, "      f[c] = make_float4(1.f, 1.f, 1.f, 1.f);\n")]),
    # a unit's copies in one group, the whole tile before its FMA (the
    # source: MU_NQ = 2, the FMA over each half once it is in)
    "mu_nq_1": (FACTOR, [(_MU_NQ, _MU_NQ.replace(" 2 ", " 1 "))]),
    # no tile staged after a block's first (its FMA, epilogue and stores
    # alone, on stale tiles; changes the result); the sum's loop unrolled by
    # 1 or 4 (the source: 2)
    "mu_no_loads": (FACTOR, [(_MU_PREFETCH, _MU_PREFETCH.replace("next < tiles", "false"))]),
    # the epilogue without its division (F * max(C - lam, 0) + acc), and
    # without its stores (a result is written only where it equals an
    # unlikely value, so that nothing is left out of the computation);
    # both change the result
    "mu_no_division": (FACTOR, [(_MU_DIV, _MU_DIV.replace("div_rn(num(a, c), den(a, c), ok)",
                                                          "num(a, c) + den(a, c)"))]),
    "mu_no_stores": (FACTOR, [(_MU_ST, "      if (o[0][c] == 12345.f)\n"
                                       "        st4(dst, make_float4(o[0][c], o[1][c], o[2][c], "
                                       "o[3][c]));\n")]),
    "mu_unroll_1": (FACTOR, [(_MU_UNROLL, _MU_UNROLL.replace("unroll 2", "unroll 1"))]),
    "mu_unroll_4": (FACTOR, [(_MU_UNROLL, _MU_UNROLL.replace("unroll 2", "unroll 4"))]),
    "mu_carveout": (FACTOR, [(_MU_READY, _MU_READY.replace(
        "    if (dev < 32)",
        "    cudaFuncSetAttribute(mu_update_kernel<TRANS, BN, ONE>,\n"
        "                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
        "    if (dev < 32)"))]),
}
SOURCES = ("mu.cu", "objectives.cu", "quotient_tile.cuh", "cp_async.cuh")


def _build(name, edits):
    """Starts nvcc on the sources with ``edits``; returns (process, .so path)."""
    texts = {f: (build.CSRC / f).read_text() for f in SOURCES}
    for old, new in edits:
        hit = [f for f, t in texts.items() if old in t]
        if not hit:
            cs.fail(f"variant {name}: a replaced line is in no source:\n{old}")
        for f in hit:
            texts[f] = texts[f].replace(old, new)
    d = ROOT / "_cache" / "variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for f, t in texts.items():
        (d / f).write_text(t)
    so = d / "lib.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         str(d / "mu.cu"), str(d / "objectives.cu"), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


# kernel: the mangled name of its k <= 64 instance
_INSTANCES = {"wtq": "wtq_kernelILb1E", "qht": "qht_kernelILb1E",
              "objective_mse": "objective_kernelILb1ELi0E",
              "objective_kl": "objective_kernelILb1ELi1E",
              "mu_factor_update_H": "mu_update_kernelILb0ELi32ELb1E",
              "mu_factor_update_W": "mu_update_kernelILb1ELi64ELb1E"}


def _ptxas(log):
    """Registers, spill bytes and barriers of each k <= 64 instance."""
    out = {}
    for kern, inst in _INSTANCES.items():
        m = re.search(rf"Compiling entry function '\S*{inst}\S*'.*?\n"
                      r".*?\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads\n.*?Used (\d+) registers, used (\d+) barriers",
                      log)
        if m:
            out[kern] = {"registers": int(m[4]), "spill_stores": int(m[2]),
                         "spill_loads": int(m[3]), "barriers": int(m[5])}
    return out


def _clean_ms(fn, reps=5):
    """``chip_smoke.time_ms`` with a flush that reads 256 MB (``sum``)
    instead of writing it: L2 is as cold, but holds nothing dirty."""
    flush = torch.empty(64 << 20, device="cuda")
    out = []
    for _ in range(reps + 1):
        flush.sum()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out[1:])[reps // 2]


def _factor_grids(M, run, k, m, sms):
    """Kernel 7 as the sources stand at one step's shape: by time_ms, after
    a clean flush and by its device time alone, and by time_ms at other tile
    widths and grids (the wrapper's rule patched)."""
    rec = {"tiling": M.mu_tiling(k, m, sms), "ms": cs.time_ms(run),
           "clean_ms": _clean_ms(run), "graph_ms": cs.graph_ms(run), "ms_by_grid": {}}
    rule, want = M.mu_tiling, run()
    try:
        for bn in M.MU_WIDTHS:
            resident = rule(k, m, sms, bn)[1]
            for blocks in sorted({resident, min(resident, sms)}):
                M.mu_tiling = lambda *a, t=(bn, blocks): t
                if not torch.equal(run(), want):
                    cs.fail(f"kernel 7 at {bn} columns, {blocks} blocks: other bits")
                rec["ms_by_grid"][f"{bn}x{blocks}"] = cs.time_ms(run, reps=3)
    finally:
        M.mu_tiling = rule
    return rec


def _entry(so, name):
    fn = getattr(ctypes.CDLL(str(so)), f"nmf_{name}")
    fn.argtypes = build._ARGTYPES[f"nmf_{name}"]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    names = sys.argv[1:] or list(VARIANTS)
    builds = {n: _build(n, VARIANTS[n][1]) for n in names}
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
    xvec = M.check_dense_problem(X, W, H, "wtq")[5]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    G_h, C_h = W.T @ W, W.T @ X
    G_w, C_w = H @ H.T, X @ H.T
    steps = {"mu_factor_update_H": (H, G_h, C_h), "mu_factor_update_W": (W.T, G_w, C_w.T)}
    for kern in QUOTIENTS + OBJECTIVES + FACTOR:
        if kern in FACTOR:
            F, G, C = steps[kern]
            kk, m = F.shape
            trans = int(not F.is_contiguous())
            want = M.mu_factor_update_plain(F.double(), G.double(), C.double(), 0.01, delta)
            res = torch.empty((m, kk), device="cuda").T if trans else torch.empty_like(F)
            wrapped = lambda F=F, G=G, C=C: M.mu_factor_update(F, G, C, 0.01, delta)  # noqa: E731
            tiling = M.mu_tiling(kk, m, sms)
            args = lambda F=F, G=G, C=C, kk=kk, m=m, trans=trans, tiling=tiling: (  # noqa: E731
                F.data_ptr(), G.data_ptr(), C.data_ptr(), res.data_ptr(), kk, m, 0.01,
                delta, trans, *tiling, stream())
            entry = "mu_factor_update"
            out.setdefault("mu", {})[kern] = _factor_grids(M, wrapped, kk, m, sms)
            # the sources' kernel launched as the variants are (the wrapper's
            # Python would hold back ten launches in a row of the H step)
            own_fn = getattr(build.load_kernels(), "nmf_mu_factor_update")

            def own_run(own_fn=own_fn, args=args):
                if own_fn(*args()):
                    raise RuntimeError("launch failed")
                return res
        elif kern in QUOTIENTS:
            plain, shape, owned, walked = {"wtq": (M.wtq_plain, (k, n), n, p),
                                           "qht": (M.qht_plain, (p, k), p, n)}[kern]
            want = plain(Xd, Wd, Hd, delta)
            splits = M.walk_splits(owned, walked, k, sms, M.QT_EDGE)
            res = torch.empty(shape, device="cuda")
            part = torch.empty((splits, *shape), device="cuda")
            own_run = lambda kern=kern: getattr(M, kern)(X, W, H, delta)  # noqa: E731
            args = lambda: (X.data_ptr(), W.data_ptr(), H.data_ptr(), part.data_ptr(),  # noqa: E731
                            res.data_ptr(), p, n, k, delta, xvec, splits, stream())
            entry = kern
        else:
            kind = kern.split("_")[1]
            want = O.dense_objective_plain(Xd, Wd, Hd, kind).reshape(1)
            splits = O.objective_splits(p, n, sms)
            res = torch.empty(1, device="cuda")
            part = torch.empty(-(-n // M.QT_EDGE) * splits, dtype=torch.float64, device="cuda")
            fn_own = O.mse_objective_kernel if kind == "mse" else O.kl_objective_kernel
            own_run = lambda fn_own=fn_own: fn_own(X, W, H).reshape(1)  # noqa: E731
            args = lambda kind=kind: (X.data_ptr(), W.data_ptr(), H.data_ptr(),  # noqa: E731
                                      part.data_ptr(), res.data_ptr(), p, n, k,
                                      O.KINDS.index(kind), xvec, splits, stream())
            entry = "dense_objective"
        for name, so in libs.items():
            if so is None:
                run = own_run
            elif kern not in VARIANTS[name][0]:
                continue
            else:
                fn = _entry(so, entry)

                def run(fn=fn, args=args):
                    err = fn(*args())
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
