#!/usr/bin/env python3
"""Time two ways of combining the pieces of a split row panel in the chunk
and quad-tail products (kernels ``chunk_matmul`` and ``quad_matmul``):

* ``scratch`` — the products' own route: each piece of a split panel writes a
  partial panel to a scratch tensor, and a second pass adds them in piece
  order (``nmf_tpu_torch/csrc/piece_walk.cuh``);
* ``cluster`` — thread-block clusters of C blocks that add the partial panels
  through distributed shared memory (``tools/cluster_combine.cu``), in one
  launch (single-piece panels packed C to a cluster, heaviest first) or in
  two (the split panels' clusters, then the single pieces, C = 1).

    python3 tools/time_cluster_combine.py

Builds ``tools/cluster_combine.cu`` into ``_cache/`` (ignored by git), makes
or reuses the 163,000 x 59,000 matrix of ``chip_smoke.py`` there (seed 0,
k 128), builds it as the chunk store and as the quad-tail store, and times
every route on both sides: L2 flushed, median of 5, with the error against
the plain version, whether two runs give the same bits and whether they
equal the scratch route's bits.  Also times the scratch route's second pass
alone.  Prints one JSON line with the card's name and power limit."""

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from nmf_tpu_torch.ops import sparse_format as sf  # noqa: E402
from nmf_tpu_torch.ops.cuda import build, sparse as S  # noqa: E402
from time_sparse_kernels import _matrix  # noqa: E402

SIZES = (2, 4, 8)  # cluster sizes tried in one launch; 4 and 8 in two


def _lib():
    so = ROOT / "_cache" / "cluster_combine.so"
    so.parent.mkdir(exist_ok=True)
    subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-I", str(build.CSRC), str(ROOT / "tools" / "cluster_combine.cu"),
         "-o", str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.x_chunk_cluster.argtypes = [P] * 13 + [I] * 6 + [P]
    lib.x_quad_cluster.argtypes = [P] * 14 + [I] * 6 + [P]
    lib.x_combine.argtypes = [P] * 4 + [I] * 4 + [P]
    return lib


def pack(pptr, pan, nreal_of_piece, C, two):
    """The launches of the cluster route: a list of (C, bpiece, bgroup,
    bdst) numpy arrays, plus (split_ptr, split_panel, n_parts) of the panels
    of more than C pieces, whose groups go through scratch."""
    starts = np.flatnonzero(np.r_[True, pan[1:] != pan[:-1]])
    counts = np.diff(np.r_[starts, len(pan)])
    big = [(a, n) for a, n in zip(starts, counts) if n > C]
    small = [(a, n) for a, n in zip(starts, counts) if 1 < n <= C]
    single = [(a, 1) for a, n in zip(starts, counts) if n == 1]
    weight = lambda g: -nreal_of_piece[g[0]:g[0] + g[1]].sum()
    small.sort(key=weight)
    single.sort(key=weight)

    def fill(groups, c, blocks, part_of=None):
        cur = 0
        for a, n in groups:
            if cur + n > c:
                blocks += [(-1, 0, -1)] * (c - cur)
                cur = 0
            blocks += [(a + i, cur << 8 | n, -1 if part_of is None else part_of)
                       for i in range(n)]
            cur = (cur + n) % c
        if cur:
            blocks += [(-1, 0, -1)] * (c - cur)

    first, sptr, span = [], [0], []
    for a, n in big:  # heaviest panels: whole clusters, then the scratch pass
        for g in range(a, a + n, C):
            fill([(g, min(C, a + n - g))], C, first, part_of=sptr[-1] + (g - a) // C)
        span.append(pan[a])
        sptr.append(sptr[-1] + -(-n // C))
    fill(small, C, first)
    launches = [(C, first)]
    if two:
        second = []
        fill(single, 1, second)
        launches.append((1, second))
    else:
        fill(single, C, first)
    arr = lambda blocks: tuple(np.asarray(c, np.int32) for c in zip(*blocks))
    return ([(c, *arr(b)) for c, b in launches if b],
            (np.asarray(sptr, np.int32), np.asarray(span, np.int32), sptr[-1]))


def route(lib, side, quad, C, two, D):
    """A closure that runs the cluster route once and returns the output."""
    q = "q" if quad else ""
    dev = D.device
    host = lambda name: getattr(side, q + name).cpu().numpy()
    pptr, pan = host("piece_ptr"), host("piece_panel")
    items = host("panel_segs" if quad else "panel_chunks")
    nreal = (side.qseg_nreal if quad else side.chunk_nreal).cpu().numpy()
    cum = np.r_[0, np.cumsum(nreal[items])]
    launches, (sptr, span, n_parts) = pack(pptr, pan, cum[pptr[1:]] - cum[pptr[:-1]], C, two)
    launches = [(c, *(torch.from_numpy(a).to(dev) for a in arrs)) for c, *arrs in launches]
    sptr, span = torch.from_numpy(sptr).to(dev), torch.from_numpy(span).to(dev)
    k = D.shape[1]
    stream = lambda: torch.cuda.current_stream().cuda_stream
    store = ((side.qpiece_ptr, side.qpiece_panel, side.qpanel_segs, side.qseg_nreal,
              side.qwin_panel, side.qlrows, side.qlcols, side.qvals) if quad else
             (side.piece_ptr, side.piece_panel, side.panel_chunks, side.chunk_nreal,
              side.win_panel, side.coords, side.vals))
    ints = (8, side.quad_seg) if quad else (side.group, side.span)
    fn = lib.x_quad_cluster if quad else lib.x_chunk_cluster

    def run():
        out = (torch.zeros if quad else torch.empty)((side.rows, k), device=dev)
        parts = torch.empty((n_parts, 128, k), device=dev)
        for c, bp, bg, bd in launches:
            err = fn(*(t.data_ptr() for t in store), bp.data_ptr(), bg.data_ptr(),
                     bd.data_ptr(), D.data_ptr(), out.data_ptr(), parts.data_ptr(),
                     bp.numel(), c, *ints, side.rows, k, stream())
            if err:
                raise RuntimeError(f"cluster launch (C {c}) failed: CUDA error {err}")
        err = lib.x_combine(sptr.data_ptr(), span.data_ptr(), parts.data_ptr(),
                            out.data_ptr(), span.numel(), side.rows, k, int(quad), stream())
        if err:
            raise RuntimeError(f"combine failed: CUDA error {err}")
        return out

    return run, sum(b.numel() for _, b, *_ in launches), int(n_parts)


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    lib = _lib()
    rows, cols, vals = _matrix(cs)
    res = {"k": cs.K, "ms": {}, "check": {}, "blocks": {}}
    for store, opts, quad in (
            ("chunk", dict(dense_tile_nnz=192, coo_tail_nnz=3), False),
            ("quad", dict(dense_tile_nnz=192, quad_tail_nnz=32), True)):
        X = sf.build_tiled(rows, cols, vals, (cs.P, cs.N), **opts)
        kern = S.quad_matmul if quad else S.chunk_matmul
        plain = S.quad_matmul_plain if quad else S.chunk_matmul_plain
        gen = torch.Generator(device="cuda").manual_seed(1)
        for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
            key = f"{'quad' if quad else 'chunk'}_matmul_{sname}"
            D = torch.rand((side.cols, cs.K), generator=gen, device="cuda")
            want = plain(side, D.double() if quad else D).float()
            scale = float(want.abs().max())
            base = kern(side, D)
            ms = {"scratch": cs.time_ms(lambda: kern(side, D))}
            q = "q" if quad else ""
            n_parts = getattr(side, f"n_{q}parts")
            parts = torch.rand((n_parts, 128, cs.K), device="cuda")
            sink = torch.zeros((side.rows, cs.K), device="cuda")
            sp, spn = getattr(side, q + "split_ptr"), getattr(side, q + "split_panel")
            ms["scratch_second_pass"] = cs.time_ms(lambda: lib.x_combine(
                sp.data_ptr(), spn.data_ptr(), parts.data_ptr(), sink.data_ptr(),
                spn.numel(), side.rows, cs.K, int(quad),
                torch.cuda.current_stream().cuda_stream))
            del parts, sink
            checks, blocks = {}, {"scratch": getattr(side, q + "piece_panel").numel()}
            for C in SIZES:
                for two in ((False, True) if C >= 4 else (False,)):
                    name = f"cluster{C}_{'two' if two else 'one'}_launch"
                    run, nb, nparts = route(lib, side, quad, C, two, D)
                    a, b = run(), run()
                    checks[name] = {
                        "max_abs_err": float((a - want).abs().max()),
                        "within_tol": bool((a - want).abs().max() <= cs.REL_TOL * scale),
                        "same_bits": bool(torch.equal(a, b)),
                        "bits_of_scratch": bool(torch.equal(a, base)),
                        "scratch_parts": nparts}
                    blocks[name] = nb
                    ms[name] = cs.time_ms(run)
            res["ms"][key], res["check"][key], res["blocks"][key] = ms, checks, blocks
            print(json.dumps({key: ms}), flush=True)
        del X
        torch.cuda.empty_cache()
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
