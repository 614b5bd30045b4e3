#!/usr/bin/env python3
"""Time kernel 11 (the column sums, ``nmf_colsum`` in
``nmf_tpu_torch/csrc/elementwise.cu``) in variants of its source, against
the source as it stands and the two-pass design it replaced
(``tools/colsum_two_pass.cu``), at the path's shape, 163,000 x 128, and at
a ragged 163,001 x 450 (the one-column loads).

    python3 tools/time_colsum.py [NAME ...]

A variant is ``elementwise.cu`` with a few lines replaced (``VARIANTS``
below; a replaced line must be in the source, or the tool fails), copied
into ``_cache/colsum/NAME/`` (ignored by git) and built there as a library
of its own, every ``nvcc`` started together.  Some variants take another
grid (``bps``: blocks a multiprocessor) than ``colsum_plan`` gives:
``main_only`` returns before the ticket (the pass over A alone; its output
is not the sums), ``no_memset`` leaves out the zeroing of the ticket (the
tool zeroes it once; ``atomicInc`` leaves it at 0), so that the two say
what the last block's adding and the memset cost; ``plain_loads`` reads A
with the default cache policy, ``ldcs_scalar`` the one-column loads
evict-first too.  For each variant and
shape, in two rounds (the variants in order, then in reverse): ms
(``chip_smoke.time_ms``: one launch after an L2 flush that leaves 50 MB
dirty, median of 11), ``clean_ms`` (after a flush that only reads),
``graph_ms`` (100 launches as one CUDA graph), the distance in ulps
from the float64 sums, whether its bits are the source's, and what
``ptxas`` reports.  Prints one JSON line with the card's name and power
limit."""

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from nmf_tpu_torch.ops.cuda import build  # noqa: E402
from nmf_tpu_torch.ops.cuda import elementwise as E  # noqa: E402

SRC = build.CSRC / "elementwise.cu"
OUT = ROOT / "_cache" / "colsum"

_NT = "#define COLSUM_NT 1024       // threads a block of the column sums\n"
_UNROLL = "#define COLSUM_UNROLL 8      // rows of loads a thread keeps in flight\n"
_TICKET = "  // the last block to finish adds every block's partial\n  __threadfence();\n"
_MEMSET = "  cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);\n"
_LDCS4 = "__device__ __forceinline__ float4 load_cols(const float4* p) { return __ldcs(p); }\n"
_LDCS1 = "__device__ __forceinline__ float load_cols(const float* p) { return *p; }\n"
# A read with the default policy, or evict-first (ld.global.cs) for the
# one-column loads too
_PLAIN = ((_LDCS4, _LDCS4.replace("__ldcs(p)", "*p")),)
_LDCS = ((_LDCS1, _LDCS1.replace("*p", "__ldcs(p)")),)

_BPS = "#define COLSUM_BPS 1         // blocks an SM: the grid's and the launch bounds'\n"
_BOUNDS = "__global__ void __launch_bounds__(COLSUM_NT, COLSUM_BPS)\n"


def _grid(nt, bps):
    return ((_NT, _NT.replace("1024", f"{nt:<4d}")),
            (_BPS, _BPS.replace(" 1 ", f" {bps} ")))


_MAIN_ONLY = ((_TICKET, "  return;\n" + _TICKET),)
_SCALAR32 = ((_UNROLL, "#define COLSUM_UNROLL (V == 4 ? 8 : 32)\n"),)

# name: (replacements, blocks a multiprocessor, same order of addition as
# the source)
VARIANTS = {
    "source": ((), 1, True),
    # the launch bounds without a least number of blocks an SM: ptxas then
    # aims at two blocks of 1,024 threads, 32 registers, one load in flight
    "bounds_nt_only": (((_BOUNDS, "__global__ void __launch_bounds__(COLSUM_NT)\n"),),
                       1, True),
    "unroll4": (((_UNROLL, _UNROLL.replace("8 ", "4 ")),), 1, True),
    "nt512_bps2": (_grid(512, 2), 2, False),
    "nt256_bps4": (_grid(256, 4), 4, False),
    "main_only": (_MAIN_ONLY, 1, None),
    "no_memset": (((_MEMSET, "  cudaError_t e = cudaSuccess;\n"),), 1, True),
    "plain_loads": (_PLAIN, 1, True),
    "plain_loads_main_only": (_PLAIN + _MAIN_ONLY, 1, None),
    "ldcs_scalar": (_LDCS, 1, True),
    # the one-column loads 32 rows deep (the bytes in flight of 8 float4s)
    "scalar32": (_SCALAR32, 1, True),
}
SHAPES = ((cs.P, cs.K), (cs.P + 1, 450))


def _build(names):
    text = SRC.read_text()
    procs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][0]:
            if old not in src:
                raise SystemExit(f"{name}: line not in the source: {old!r}")
            src = src.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "elementwise.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / "elementwise.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if re.search(r"colsum|registers|spill", ln)
                       and "scale_cols" not in ln and "projectnn" not in ln]
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.nmf_colsum.argtypes = build._ARGTYPES["nmf_colsum"]
        lib.nmf_colsum.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool only runs on the card")
    names = argv or list(VARIANTS)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    two_pass = cs.load_two_pass_colsum(cs.start_two_pass_colsum_build())
    libs, ptxas = _build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(11)
    rec = {"card": smi, "ptxas": ptxas, "shapes": {}}

    def timed(run):
        return {"ms": cs.time_ms(run, reps=11),
                "clean_ms": cs.time_ms(run, reps=11, clean=True),
                "graph_ms": cs.graph_ms(run)}

    for m, n in SHAPES:
        A = torch.rand((m, n), generator=gen, device="cuda") + 0.1
        want = A.double().sum(0)
        vec = int(n % 4 == 0)
        row = {"bound_ms": cs.bound_of(4 * m * n + 4 * n, m * n)[0]}
        nb = -(-m // 256)
        partial = torch.empty((nb, n), dtype=torch.float64, device="cuda")
        old = torch.empty(n, device="cuda")
        runs = {
            "sum0": lambda: A.sum(0),
            "two_pass_partial": lambda: two_pass.two_pass_colsum_partial(
                A.data_ptr(), partial.data_ptr(), m, n,
                torch.cuda.current_stream().cuda_stream),
            "two_pass_finish": lambda: two_pass.two_pass_colsum_finish(
                partial.data_ptr(), old.data_ptr(), m, n,
                torch.cuda.current_stream().cuda_stream),
        }
        ref = None
        for name in names:
            bps, same_order = VARIANTS[name][1:]
            blocks = max(1, min(bps * sms, m // E.COLSUM_MIN_ROWS))
            rows = -(-m // blocks)
            blocks = -(-m // rows)
            scratch = torch.zeros(blocks * n + 1, dtype=torch.float64, device="cuda")
            out = torch.empty(n, device="cuda")

            def run(name=name, scratch=scratch, out=out, blocks=blocks, rows=rows):
                if libs[name].nmf_colsum(
                        A.data_ptr(), scratch.data_ptr(), out.data_ptr(), m, n,
                        blocks, rows, vec, torch.cuda.current_stream().cuda_stream):
                    raise SystemExit(f"{name} failed to launch")

            run()
            torch.cuda.synchronize()
            r = {"blocks": blocks, "rows": rows}
            if same_order is not None:
                r["ulps"] = cs._ulps_off(out, want)
                if name == "source":
                    ref = out.clone()
                elif same_order and ref is not None:
                    r["source_bits"] = bool(torch.equal(out, ref))
            row[name] = r
            runs[name] = run
        # two rounds, the second in reverse order: a drift shows as a spread
        order = list(runs)
        for rnd, names_in_turn in enumerate((order, order[::-1])):
            for name in names_in_turn:
                row.setdefault(name, {})[f"round{rnd}"] = timed(runs[name])
        rec["shapes"][f"{m}x{n}"] = row
        del A, want, partial, runs
    print(smi, flush=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
