#!/usr/bin/env python3
"""Time variants of a sampled-product kernel of one checkout: kernel 4
(``csrc/chunk_sddmm.cu``) on the forward side of the ttt4 chunk store of
``chip_smoke.py`` (163,000 x 59,000, seed 0, k 128), or with ``quad`` kernel
5 (``csrc/quad_sddmm.cu``) on the forward side of its quad store.

    python3 tools/time_sddmm_variants.py [TREE] [quad]

``TREE`` is the root of a checkout (default: this one).  Each variant is the
tree's source of the kernel and its headers with a few lines replaced
(``VARIANTS`` below; a variant whose lines are in none of the tree's sources
is skipped and reported; a ``warp_`` variant is of the one-warp routine
(``sddmm_warp.cuh``, which kernel 5 used before it walked pieces) and a
``piece_`` one of the walk over pieces (``chunk_sddmm.cu``, later
``sddmm_piece.cuh``), each built for a tree whose kernel has that routine),
built into ``_cache/sddmm/`` (ignored by git), all ``nvcc`` started
together, and launched through the tree's own wrapper, its entry point
swapped for the variant's.  The variants take parts of the work away (the
gathers of W or of H, or both; they change the result) or change the
tree's design (the slots a group samples at once, the lanes a slot, the
staged panel), and so say where the time goes.  For each: ms (L2 flushed,
median of 9, taken in three passes over all the variants in turns; the
median pass and each), the error against the plain version run in float64,
whether two runs give the same bits, and the registers ``ptxas`` reports
for the kernel's instances.
Prints one JSON line with the card's name and power limit."""

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the one-warp routine (sddmm_warp.cuh: kernel 4 before it walked pieces,
# kernel 5 before it walked them too)
_WARP_LOADS = ("        const float4 a = w4[j];\n"
               "        const float4 b = h4[j];\n")
_WARP_H = "    const float* h = Ht + (size_t)__shfl_sync(0xffffffffu, col, s) * k;\n"
_WARP_W = "    const float* w = W + (size_t)__shfl_sync(0xffffffffu, row, s) * k;\n"
# the walk over pieces (chunk_sddmm.cu; now sddmm_piece.cuh, both kernels)
_PIECE_H = "        const float* h = Ht + (size_t)col * k;\n"
_PIECE_HLOAD = ("        hb[t] = ok && j < len ? reinterpret_cast<const float4*>(h)[j]\n"
                "                              : make_float4(0.f, 0.f, 0.f, 0.f);\n")
_STAGE_K = "#define SD_STAGE_K 192 "
_NT = "#define SD_NT 512 "
_SLOTS = "#define SD_SLOTS 2048 "
_PASS = "#define SD_PASS 8 "
_BOUNDS = "__global__ void __launch_bounds__(SD_NT)\nsddmm_piece_kernel("
_ZERO = "    zero_empty_items<SHIFT>(nreal, out"

# the walk of one slot a group (the source) and of SD_U slots a group at
# once, the gathers of all SD_U in flight together (the form before the
# source took one)
_ONE_DOT = r'''// sum_j w[j] h[j] over this lane's share (j = l, l + G, ..., in increasing
// order) of one slot; ``ok``: the slot is real (else 0, nothing read).
// VEC: k % 4 == 0 and both rows 16-byte aligned, float4 a step.
template <bool VEC>
__device__ __forceinline__ float lane_dot(const float* w, const float* h,
                                          bool ok, int l, int G, int k) {
  const int len = VEC ? k >> 2 : k;
  float acc = 0.f;
  for (int j0 = l; j0 < len; j0 += 4 * G) {
    if (VEC) {
      float4 hb[4];  // the gathers first, all in flight together
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        hb[t] = ok && j < len ? reinterpret_cast<const float4*>(h)[j]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        if (ok && j < len) {
          const float4 a = reinterpret_cast<const float4*>(w)[j];
          acc = fmaf(a.x, hb[t].x, acc);
          acc = fmaf(a.y, hb[t].y, acc);
          acc = fmaf(a.z, hb[t].z, acc);
          acc = fmaf(a.w, hb[t].w, acc);
        }
      }
    } else {
      float hb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        hb[t] = ok && j < len ? h[j] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        if (ok && j < len) acc = fmaf(w[j], hb[t], acc);
      }
    }
  }
  return acc;
}

'''
_MULTI_DOT = r'''// sum_j w[j] h[j] over this lane's share (j = l, l + G, ..., in increasing
// order) of one slot; ``ok``: the slot is real (else 0, nothing read).
// VEC: k % 4 == 0 and both rows 16-byte aligned, float4 a step.
template <bool VEC>
__device__ __forceinline__ void lane_dots(float (&acc)[SD_U],
                                          const float* (&w)[SD_U],
                                          const float* (&h)[SD_U],
                                          const bool (&ok)[SD_U], int l, int G,
                                          int k) {
  const int len = VEC ? k >> 2 : k;
  for (int j0 = l; j0 < len; j0 += 4 * G) {
    if (VEC) {
      float4 hb[SD_U][4];  // the gathers first, all in flight together
#pragma unroll
      for (int u = 0; u < SD_U; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t * G;
          hb[u][t] = ok[u] && j < len ? reinterpret_cast<const float4*>(h[u])[j]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < SD_U; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t * G;
          if (ok[u] && j < len) {
            const float4 a = reinterpret_cast<const float4*>(w[u])[j];
            acc[u] = fmaf(a.x, hb[u][t].x, acc[u]);
            acc[u] = fmaf(a.y, hb[u][t].y, acc[u]);
            acc[u] = fmaf(a.z, hb[u][t].z, acc[u]);
            acc[u] = fmaf(a.w, hb[u][t].w, acc[u]);
          }
        }
    } else {
      float hb[SD_U][4];
#pragma unroll
      for (int u = 0; u < SD_U; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t * G;
          hb[u][t] = ok[u] && j < len ? h[u][j] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < SD_U; ++u)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = j0 + t * G;
          if (ok[u] && j < len) acc[u] = fmaf(w[u][j], hb[u][t], acc[u]);
        }
    }
  }
}

'''
_ONE_WALK = r'''      // a slot a group; every lane of a warp takes the same number of
      // rounds (the shuffles want the whole warp)
      for (int base = warp * groups; base < ne; base += (SD_NT / 32) * groups) {
        const int e = base + gw;
        const bool mine = e < ne;
        const int hw = mine ? tab_hw[e] : -1;
        const int slot = mine ? tab_slot[e] : 0;
        const int lrow = hw & (TILE - 1), col = hw >> 7;
        const float* w = STAGED ? Ws + lrow * kp : W + (size_t)(r0 + lrow) * k;
        const float* h = Ht + (size_t)col * k;
        float acc = lane_dot<VEC>(w, h, hw >= 0, l, g, k);
        for (int off = g >> 1; off; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (mine && l == 0) out[slot] = acc;
      }
'''
_MULTI_WALK = r'''      const int per_warp = groups * SD_U;  // slots a warp takes a round
      // SD_U slots a group at once; every lane of a warp takes the same
      // number of rounds (the shuffles want the whole warp)
      for (int base = warp * per_warp; base < ne; base += (SD_NT / 32) * per_warp) {
        int slot[SD_U];
        bool ok[SD_U], mine[SD_U];
        const float* w[SD_U];
        const float* h[SD_U];
#pragma unroll
        for (int u = 0; u < SD_U; ++u) {
          const int e = base + u * groups + gw;
          mine[u] = e < ne;
          const int hw = mine[u] ? tab_hw[e] : -1;
          slot[u] = mine[u] ? tab_slot[e] : 0;
          ok[u] = hw >= 0;
          const int lrow = hw & (TILE - 1), col = hw >> 7;
          w[u] = STAGED ? Ws + lrow * kp : W + (size_t)(r0 + lrow) * k;
          h[u] = Ht + (size_t)col * k;
        }
        float acc[SD_U];
#pragma unroll
        for (int u = 0; u < SD_U; ++u) acc[u] = 0.f;
        lane_dots<VEC>(acc, w, h, ok, l, g, k);
#pragma unroll
        for (int u = 0; u < SD_U; ++u) {
          for (int off = g >> 1; off; off >>= 1)
            acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
          if (mine[u] && l == 0) out[slot[u]] = acc[u];
        }
      }
'''


def _slots_at_once(u):
    """The edits that make a group sample ``u`` slots at once."""
    return [(_ONE_DOT, f"#define SD_U {u}\n\n" + _MULTI_DOT),
            (_ONE_WALK, _MULTI_WALK)]


# name: [(text in a source, its replacement), ...]
VARIANTS = {
    # the one-warp kernel: no gathers at all (the store, the padding walk,
    # the butterflies and the writes); W rows only (H read from row 0, an L1
    # hit); H rows only
    "warp_no_gathers": [(_WARP_LOADS, "        const float4 a = make_float4(1.f, 1.f, 1.f, 1.f);\n"
                                      "        const float4 b = a;\n")],
    "warp_w_only": [(_WARP_H, "    const float* h = Ht;\n")],
    "warp_h_only": [(_WARP_W, "    const float* w = W;\n")],
    # the piece kernel: H read from row 0 (an L1 hit); no H load at all; W
    # gathered as H is (no staged panel); two or four slots a group at once
    # (the source: one); blocks of 256 or 1024 threads; tables of 1024
    # slots; four slots' loads in flight a thread in the table pass; other
    # lanes a slot (set through the wrapper below)
    "piece_h_row0": [(_PIECE_H, "        const float* h = Ht;\n")],
    "piece_no_h_loads": [(_PIECE_HLOAD, "        hb[t] = make_float4(1.f, 1.f, 1.f, 1.f);\n")],
    "piece_w_gathered": [(_STAGE_K, "#define SD_STAGE_K 0 ")],
    "piece_u2": _slots_at_once(2),
    "piece_u4": _slots_at_once(4),
    "piece_nt_256": [(_NT, "#define SD_NT 256 ")],
    "piece_nt_1024": [(_NT, "#define SD_NT 1024 ")],
    "piece_slots_1024": [(_SLOTS, "#define SD_SLOTS 1024 ")],
    "piece_pass_4": [(_PASS, "#define SD_PASS 4 ")],
    "piece_lanes_4": [],
    "piece_lanes_16": [],
    # the walk over pieces at most 64 registers a thread (two blocks an SM);
    # the blocks past the pieces leave the items without entries unwritten
    # (what zeroing them costs; changes the result)
    "piece_min_blocks_2": [(_BOUNDS, _BOUNDS.replace("(SD_NT)", "(SD_NT, 2)"))],
    "piece_no_zero_blocks": [(_ZERO, _ZERO.replace("    zero_empty_items", "    return;\n    zero_empty_items"))],
}
# times each variant is timed, in turns with the others
PASSES = 3
# variants that change the wrapper's lanes a slot, not the source
LANES = {"piece_lanes_4": 4, "piece_lanes_16": 16}


def _build(tree, source, name, edits):
    """Starts nvcc on the tree's ``source`` with ``edits``; returns
    (process, .so path), or None where an edit hits no source."""
    csrc = tree / "nmf_tpu_torch" / "csrc"
    texts = {f.name: f.read_text() for f in csrc.iterdir()
             if f.name == source or f.suffix == ".cuh"}
    for old, new in edits:
        hit = [f for f, t in texts.items() if old in t]
        if not hit:
            return None
        for f in hit:
            texts[f] = texts[f].replace(old, new)
    d = ROOT / "_cache" / "sddmm" / tree.name / source.split(".")[0] / name
    d.mkdir(parents=True, exist_ok=True)
    for f, t in texts.items():
        (d / f).write_text(t)
    so = d / "lib.so"
    from nmf_tpu_torch.ops.cuda import build

    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         str(d / source), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


class _Swapped:
    """The kernels' library with one entry point swapped."""

    def __init__(self, lib, name, fn):
        self._lib, self._name, self._fn = lib, name, fn

    def __getattr__(self, attr):
        return self._fn if attr == self._name else getattr(self._lib, attr)


def main():
    args = sys.argv[1:]
    quad = "quad" in args
    rest = [a for a in args if a != "quad"]
    tree = pathlib.Path(rest[0] if rest else ROOT).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from nmf_tpu_torch.ops import sparse_format as sf
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.cuda import sparse as S

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    source = "quad_sddmm.cu" if quad else "chunk_sddmm.cu"
    entry = "nmf_" + source.split(".")[0]
    kernel = S.quad_sddmm if quad else S.chunk_sddmm
    plain = S.quad_sddmm_plain if quad else S.chunk_sddmm_plain
    # a "warp_" variant is of the one-warp routine, a "piece_" one of the
    # walk over pieces: each is built where the tree's kernel has that routine
    walks = ((tree / "nmf_tpu_torch" / "csrc" / "sddmm_piece.cuh").exists() if quad
             else hasattr(S, "sddmm_lanes"))
    kind = "piece_" if walks else "warp_"
    builds, skipped = {}, []
    for name, edits in VARIANTS.items():
        got = _build(tree, source, name, edits) if name.startswith(kind) else None
        if got is None:
            skipped.append(name)
        else:
            builds[name] = got
    sys.path.insert(0, str(ROOT / "tools"))
    from time_sparse_kernels import _matrix

    rows, cols, vals = _matrix(cs)
    opts = dict(quad_tail_nnz=32) if quad else dict(coo_tail_nnz=3)
    X = sf.build_tiled(rows, cols, vals, (cs.P, cs.N), dense_tile_nnz=192, **opts)
    side = X.fwd
    gen = torch.Generator(device="cuda").manual_seed(2)
    W = torch.rand((side.rows, cs.K), generator=gen, device="cuda")
    Ht = torch.rand((side.cols, cs.K), generator=gen, device="cuda")
    want = plain(side, W.double(), Ht.double())
    lib = build.load_kernels()
    out = {"tree": str(tree), "kernel": source, "k": cs.K, "ms": {}, "rel_err": {},
           "same_bits": {}, "skipped": skipped, "build_errors": {}, "registers": {}}
    runs = {"own": None}
    for name, (proc, so) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            out["build_errors"][name] = log[-2000:]
            continue
        out["registers"][name] = sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)})
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = build._ARGTYPES[entry]
        fn.restype = ctypes.c_int
        runs[name] = fn
    lanes = getattr(S, "sddmm_lanes", None)
    out["ms_by_pass"] = {name: [] for name in runs}
    for pass_ in range(PASSES):  # every variant once a pass, in turns
        for name, fn in runs.items():
            build._lib = lib if fn is None else _Swapped(lib, entry, fn)
            if name in LANES:
                S.sddmm_lanes = lambda k, g=LANES[name]: g
            try:
                if pass_ == 0:
                    got = kernel(side, W, Ht)
                    torch.cuda.synchronize()
                    out["rel_err"][name] = float(
                        (got.double() - want).abs().max() / want.abs().max())
                    out["same_bits"][name] = bool(torch.equal(got, kernel(side, W, Ht)))
                out["ms_by_pass"][name].append(cs.time_ms(lambda: kernel(side, W, Ht), reps=9))
            except RuntimeError as err:  # a variant the card refuses: reported
                out.setdefault("launch_errors", {})[name] = str(err)
            finally:
                build._lib = lib
                if lanes is not None:
                    S.sddmm_lanes = lanes
    out["ms"] = {name: statistics.median(v) for name, v in out["ms_by_pass"].items() if v}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
