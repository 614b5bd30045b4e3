#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA build: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card, ``nvcc`` and no network.  It builds the
fourteen CUDA kernels from ``nmf_tpu_torch/csrc/`` (the twelve that replace
the TPU kernels, the COO band's and the general-CSR product's), holds each kernel against its plain
PyTorch version on the card (the product and multiplicative-update kernels
also at every ``k`` they refused before they summed over ``k`` in slabs), and
drives the ported paths through ``nnmf`` and the resumable solver loop:

* sparse Fast-HALS on the 163,000 x 59,000 power-law problem (about 17.6M
  nonzeros, rank 128) down to relative error 0.84;
* greedy coordinate descent (the ``nnmf`` default solver) on the same store,
  to the same relative error or 200 iterations;
* Fast-HALS, greedy coordinate descent and the KL multiplicative updates on
  the quad-tail store of the same matrix;
* the ``nnmf`` defaults on the same store: the NNDSVD-ar start over a
  randomized SVD, timed in its parts, GreedyCD from it to the same relative
  error, and the literal ``nnmf(X, 128)``; a normalised random start with a
  second replicate;
* multiplicative updates (KL divergence and MSE) on the first tiled store;
* projected ALS and ALS projected gradient for ten traced iterations each on
  the first tiled store, then SPA on it at rank 128 (spa4): the anchors, the
  exact anchor columns, the batched FNNLS by cascade level with its KKT
  conditions in every column, and ``nnmf(X, 128, init="spa", alg="spa")``;
* the same matrix as a ``torch.sparse_csr_tensor`` on the card (the port's
  general sparse X): its products against the store's, the same bits twice,
  HALS to relative error 0.84, five KL sweeps and ``nnmf(Xs, 128,
  maxiter=5)`` against the store's runs from the same starts, each through
  the general-CSR kernel and never the band kernel (phase
  ``sparse_general``); the general-CSR kernel over all of it against
  float64, the same bits twice, its rows of one piece against the band
  kernel over the rows bit for bit, timed beside ``torch.sparse.mm``, and
  swept over its piece caps, column slabs and loads; the sampled product
  over X beside ``torch.sparse.sampled_addmm`` (phase
  ``kernels_general_csr``);
* ``solve_checkpointed`` against ``solve``, the same bits: shuffled HALS (25
  iterations, a snapshot every 7; also cut at 14 and resumed) and GreedyCD
  (10, every 4) on the store, ALSPGrad on the dense problem below (12, every
  5), with a snapshot's bytes and the seconds of a save and a load (phase
  ``checkpoint``);
* the matrix written as a Matrix Market file and read back through the
  port's loader, then ``nnmf`` on it (phase ``loader``);
* the multi-device path (phase ``sharded``): the matrix cut by
  ``shard_tiled`` into a 2 x 2 mesh of stores over one card (and a (1, 1)
  mesh, whose products give the chunk store's bits), the build timed and
  the blocks' loads reported; the mesh's products within ``REL_TOL`` of
  the store's, the same bits twice, timed beside the store's; HALS to
  relative error 0.84, 10 GreedyCD iterations, 5 KL sweeps and
  ``nnmf(X, 128, mesh=mesh, maxiter=5)`` on the mesh beside the store's
  runs; 5 HALS iterations and 5 KL sweeps on a quad-tail 2 x 2 mesh
  against the quad store's; with more than one card, the same mesh shape
  over distinct cards gives the one-card mesh's bits;
* batched restarts (phase ``replicates_batched``): one store product of
  width 4 x 128 against four of width 128 (each column's bits, both
  times); ``nnmf(X, 128, alg=..., init="random", replicates=...,
  parallel_replicates=True)`` against the restarts one after the other for
  HALS (5, 25 iterations), GreedyCD (4, 5; its masked-step host reads
  counted both ways) and the KL updates (3, 5; the sequential bits), each
  lane against its sequential restart, the store's kernels at the batch's
  width; HALS (4, 10) and ALS projected gradient (3, 2) on the dense
  problem below (phase ``replicates_batched_dense``);
* the dense problem below cut into a 2 x 2 mesh of dense blocks over one
  card and a (1, 1) one (phase ``sharded_dense``): the products, kernels 8
  and 9 and both objectives a block against the whole X's (the (1, 1)
  mesh's bits the whole X's), the same bits twice, timed beside them;
  kernels 8, 9 and 6 at a block's shape against their plain versions; 10
  KL and 10 MSE sweeps and 5 HALS iterations beside the whole X's,
  ``nnmf(Xd, 64, mesh=mesh, maxiter=20)`` and three restarts of the MSE
  updates as one batch on the mesh;
* one process a card (phase ``multiprocess``): two worker processes of this
  script (``--rank R ...``) over gloo on ``cuda:0``, each building its own
  row of blocks of the first matrix's 2 x 2 mesh from its own entries
  (``shard_tiled(..., local=True)``) and keeping its own row of the dense
  problem's 2 x 2 mesh; the products, 5 HALS iterations, 5 KL sweeps and
  ``nnmf(X, 128, mesh=mesh, maxiter=3)``, then the dense mesh's products,
  quotient products, objectives and 5 KL sweeps, each rank's result the
  one-process meshes' bit for bit (digests); with two cards once more over
  NCCL, one card a rank;
* multiplicative updates on a dense 100,000 x 10,000 low-rank problem at rank
  64, and on the two small dense problems (500 x 500 rank 8 to relative
  error 0.010, 2000 x 1000 rank 32 to 0.020); ``nnmf`` with its defaults on
  the dense problem; projected ALS and ALS projected gradient on the dense
  problem to relative error 0.0125 (ttt3), and ``nnmf`` with each.

Kernels 8, 9 and 6 are also held at ragged shapes, unaligned rows and k on
both sides of a slab (phase ``kernels_dense_edges``), kernels 4 and 5 at k
on both sides of their lanes' and their staged panel's widths, on wide tail
tiles, at seg 32 and 16 and on stores of nearly all padding (phase
``kernels_sddmm_edges``).  Kernel 7 is timed at each of its tile widths
(``ms_by_width``).  The dense kernels are also timed at the small problems'
shapes, where most of their launches are (phases ``kernels_dense_ttt1`` and
``kernels_dense_ttt2``: kernel 7, kernels 8 and 9), there also by their
device time alone (``graph_ms``: 100 launches as one CUDA graph, replayed),
and kernel 10 at the dense problem's factors; the ``kernels`` line gives
such a kernel's times and launches shape by shape (``by_shape``), and the
launch floor: the lightest launch ``time_ms`` can measure, and its device
time (``launch_floor_ms``, ``launch_floor_graph_ms``).
Kernels 1, 2 and 3 are also run with most row panels cut into several
pieces (phase ``kernels_split``), and the products over the first store and
five HALS iterations on it give the same bits twice (phase
``same_bits_products``).  Kernel 11 is held at ragged and narrow shapes
within 1 ulp of the float64 sums, twice and from two streams, and timed
beside the two-pass design it replaced, built from
``tools/colsum_two_pass.cu`` (phase
``kernels_colsum``); the store's row and column sums repeat bit for bit
(phase ``sparse_sums``); a caller who turned TF32 on gets the solves' bits
and its setting back (phase ``precision``).  Every phase prints one JSON
line; the ``kernels`` line gives each use of a kernel its own times
(``fwd_ms``, ``fwd_plain_ms``, ``fwd_library_ms``, ``fwd_bound_ms``) beside
the sums over its uses (``summed_over``).  Any failure
ends the run with a non-zero exit code.  There is no CPU path: without a
card the script fails at once.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import math
import pathlib
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks used for the bounds
MEM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA cores
# tensor cores, dense TF32: the dense-tile kernel (kernel 2) does each of its
# float32 products as three TF32 ones (3xTF32), exact to float32's rounding
TF32_FLOPS = 495e12

# kernel vs plain version: f32 sums taken in another order.  The longest run
# of float32 additions in one thread is about 10,000 terms (qht walks all of
# n; wtq's walk over p is cut into runs), whose rounding error grows like
# sqrt(terms) * 6e-8 = 6e-6 against the float64 reference
REL_TOL = 2e-5
# the objective sums each thread's 64 float32 terms of a step in float32 and
# adds that sum into a double: what is left is the float32 rounding of each
# W @ H entry and of those short sums, which averages out over 1e9 terms
OBJECTIVE_TOL = 2e-6
MONOTONE_TOL = 1e-4  # an objective may rise by this much, relative, per step
# column sums added in double and rounded once; the scaling divides once
EW_REL_TOL = 1e-6
TARGET_RELERR = 0.84
TTT3_TARGET = 0.0125  # benchmarks/run.py's ttt3 target for both ALS solvers
# FNNLS's residual on the passive set, relative to |AtA| |x| + |AtB|: a
# float64 LU solve is backward stable to about k * eps = 3e-14 at k 128
KKT_REL = 1e-9
P, N, K = 163_000, 59_000, 128
DP, DN, DK = 100_000, 10_000, 64  # the dense multiplicative-update problem
MP_SEED = 31  # the multiprocess phase's operands and starts
MP_TIMEOUT = 300  # seconds both of the phase's worker processes may take


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _movielens_like(rng, p=P, n=N, nnz=25_000_000):
    """Power-law (ratings-like) sparse pattern: Pareto row and column
    draws, shuffled ids, duplicates dropped."""
    rows = np.minimum((rng.pareto(1.2, nnz) * p / 50), p - 1).astype(np.int64)
    cols = np.minimum((rng.pareto(1.2, nnz) * n / 50), n - 1).astype(np.int64)
    rows = rng.permutation(p)[rows]
    cols = rng.permutation(n)[cols]
    key = np.unique(rows * n + cols)
    rows, cols = (key // n).astype(np.int32), (key % n).astype(np.int32)
    vals = (rng.random(len(key)) * 4 + 1).astype(np.float32)
    return rows, cols, vals


def _lowrank_noisy(rng, p, n, k, noise=0.01):
    """Rank-k nonnegative signal + uniform noise (host version, for the small
    problems)."""
    Wg = rng.random((p, k), dtype=np.float32)
    Hg = rng.random((k, n), dtype=np.float32)
    return Wg @ Hg + noise * rng.random((p, n), dtype=np.float32)


def _lowrank_noisy_on_card(rng, p, n, k, noise=0.01):
    """The same kind of problem at a size the host should not hold twice: the
    factors come from the numpy generator, the product and the noise are made
    on the card (noise from a seeded CUDA generator)."""
    Wg = torch.from_numpy(rng.random((p, k), dtype=np.float32)).cuda()
    Hg = torch.from_numpy(rng.random((k, n), dtype=np.float32)).cuda()
    X = Wg @ Hg
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = 10_000  # rows of noise made at once
    for i0 in range(0, p, step):
        X[i0 : i0 + step] += noise * torch.rand(
            (min(step, p - i0), n), generator=gen, device="cuda")
    return X


def bound_of(nbytes, flops, rate=FP32_FLOPS):
    """Least milliseconds the card could take for this work, and what bounds
    it: every input read once and the output written once at the memory rate,
    against the flops at ``rate`` (the fp32 CUDA-core peak unless given)."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# timing


_flush_buf = None


def _flush_l2(clean=False):
    """Overwrite 256 MB so the next launch finds the 50 MB L2 cold, as a
    launch inside a HALS sweep does (the column loop streams the factor
    128 times between two products).  That leaves up to 50 MB of dirty
    lines, which the next launch writes back as it fills L2; ``clean``
    reads the 256 MB instead, so nothing is left to write back."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    if clean:
        _flush_buf.max()
    else:
        _flush_buf.zero_()


def time_ms(fn, reps=5, warmup=1, clean=False):
    """Median milliseconds of ``fn()`` by CUDA events, L2 flushed before
    each launch (``_flush_l2``), a synchronize between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        _flush_l2(clean)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def graph_ms(fn, launches=100, reps=5):
    """Device milliseconds of one ``fn()`` with the host out of the way:
    ``launches`` calls captured as one CUDA graph, replayed between two
    events (median of ``reps`` replays after a warm-up one), divided by
    ``launches``; L2 not flushed, as a small problem's operands stay in it
    across a solve.  A measurement only: no solver path replays a graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(out)


def launch_floor():
    """The lightest launch ``time_ms`` can measure (kernel 10 on one float,
    through its wrapper), and its device time by ``graph_ms``: what a row of
    the kernel table cannot go below."""
    from nmf_tpu_torch.ops.cuda import elementwise as E

    A = torch.ones((1, 1), device="cuda")
    return {"ms": time_ms(lambda: E.projectnn(A)), "graph_ms": graph_ms(lambda: E.projectnn(A))}


# ---------------------------------------------------------------------------
# kernels against their plain versions


def _class_csr(side, cls):
    """The entries of one store class as a torch CSR tensor (the yardstick's
    input), plus their count."""
    from nmf_tpu_torch.ops.sparse_format import DENSE_GROUP, TILE

    pps = side.panels_per_stripe
    if cls == "chunk":
        ids = side.panel_chunks.long()
        win = ids // side.group
        co = side.coords[ids].long()
        panel = side.win_stripe[win].long() * pps + side.chunk_rp[ids].long()
        rows = panel[:, None] * TILE + (co & (TILE - 1))
        cols = side.win_panel[win].long()[:, None] * (TILE * side.span) + (co >> 7)
        vals = side.vals[ids]
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    elif cls == "quad":
        from nmf_tpu_torch.ops.cuda.sparse import quad_rows_cols

        rows, cols = quad_rows_cols(side, 0, side.n_qchunks, side.qvals.device)
        keep = side.qvals != 0
        rows, cols, vals = rows[keep], cols[keep], side.qvals[keep]
    elif cls == "band":
        rows, cols, vals = side.coo_rows.long(), side.coo_cols.long(), side.coo_vals
    else:
        ids = side.dpanel_blocks.long()
        win = ids // DENSE_GROUP
        panel = side.dblk_stripe[win].long() * pps + side.dblk_rp[ids].long()
        b, c, r = side.dvals[ids].nonzero(as_tuple=True)
        rows = panel[b] * TILE + r
        cols = side.dblk_panel[win].long()[b] * TILE + c
        vals = side.dvals[ids][b, c, r]
    A = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), vals, (side.rows, side.cols)
    ).coalesce().to_sparse_csr()
    return A, int(vals.numel())


def _bound(side, cls, k, nnz):
    """Least milliseconds the card could take: every input read once and the
    output written once at the memory rate, against the flops this data
    needs at the fp32 CUDA-core peak; for the dense class (whose kernel runs
    on the tensor cores) at the TF32 peak for three times the flops, with
    the CUDA-core bound as a seventh value.  Returns (ms, by, bytes, flops,
    items, CUDA-core ms)."""
    from nmf_tpu_torch.ops.sparse_format import TILE

    d_and_out = 4 * k * (side.cols + side.rows)
    if cls == "chunk":
        n_items = side.panel_chunks.numel()
        nbytes = (n_items * (TILE * 8 + 4) + 4 * side.panel_ptr.numel()
                  + 4 * side.win_panel.numel() + d_and_out)
        flops = 2 * nnz * k
    elif cls == "quad":
        # the sub-segments that hold entries: 12 bytes a slot and one index
        # word each; the kernel adds into its output (read once, written once)
        n_items = side.qpanel_segs.numel()
        nbytes = (n_items * (side.quad_seg * 12 + 4) + 4 * side.qpanel_ptr.numel()
                  + 4 * side.qwin_panel.numel() + d_and_out + 4 * k * side.rows)
        flops = 2 * nnz * k
    elif cls == "band":
        # the row pointer, a column and a value an entry; the rows of D the
        # band reads, and the rows of the output it adds into (read, written)
        n_items = side.n_coo
        d_rows = int(torch.unique(side.coo_cols).numel())
        out_rows = int((side.coo_ptr.diff() > 0).sum())
        nbytes = (4 * side.coo_ptr.numel() + 8 * n_items + 4 * k * d_rows
                  + 8 * k * out_rows)
        flops = 2 * nnz * k
    else:
        n_items = side.dpanel_blocks.numel()
        # the dense kernel adds into its output: read once and written once
        nbytes = (n_items * (TILE * TILE * 4 + 4) + 4 * side.dpanel_ptr.numel()
                  + 4 * side.dblk_panel.numel() + d_and_out + 4 * k * side.rows)
        flops = 2 * TILE * TILE * k * n_items
        return (*bound_of(nbytes, 3 * flops, TF32_FLOPS), nbytes, flops, n_items,
                bound_of(nbytes, flops)[0])
    return (*bound_of(nbytes, flops), nbytes, flops, n_items, None)


def balance(side, cls):
    """How the work of one store class is spread over thread blocks: the
    pieces, the panels split into several, the most entries in one piece and
    in one panel."""
    q = "q" if cls == "quad" else ""
    items = getattr(side, "qpanel_segs" if q else "panel_chunks").long()
    ptr = getattr(side, "qpanel_ptr" if q else "panel_ptr").long()
    nreal = getattr(side, "qseg_nreal" if q else "chunk_nreal")
    cum = torch.zeros(items.numel() + 1, dtype=torch.int64, device=items.device)
    cum[1:] = nreal[items].long().cumsum(0)
    pp = getattr(side, q + "piece_ptr").long()
    return {"pieces": pp.numel() - 1,
            "panels": int((ptr.diff() > 0).sum()),
            "split_panels": getattr(side, q + "split_panel").numel(),
            "max_entries_in_a_piece": int((cum[pp[1:]] - cum[pp[:-1]]).max()),
            "max_entries_in_a_panel": int((cum[ptr[1:]] - cum[ptr[:-1]]).max())}


def check_kernels(X, k, label, timed, classes=("chunk", "dense", "band")):
    """Each product kernel of ``classes`` against its plain version, both
    orientations.  Returns ``{kernel: {side: record}}``; exits when a result
    disagrees.  The quad, dense and band kernels are held against their plain
    versions run in float64.  The chunk and quad kernels' records carry the
    store's balance (``balance``), the dense kernel's its pieces."""
    from nmf_tpu_torch.ops.cuda import sparse as S

    kernels = {
        "chunk": ("chunk_matmul", S.chunk_matmul, S.chunk_matmul_plain),
        "dense": ("dense_matmul", S.dense_matmul, S.dense_matmul_plain),
        "quad": ("quad_matmul", S.quad_matmul, S.quad_matmul_plain),
        # the band adds into an output: here into zeros
        "band": ("coo_matmul",
                 lambda side, D: S.coo_matmul(side, D, torch.zeros(
                     (side.rows, D.shape[1]), dtype=torch.float32, device=D.device)),
                 lambda side, D: S.coo_matmul_plain(side, D, torch.zeros(
                     (side.rows, D.shape[1]), dtype=D.dtype, device=D.device))),
    }
    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {kernels[cls][0]: {} for cls in classes}
    for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
        D = torch.rand((side.cols, k), generator=gen, device="cuda")
        for cls in classes:
            name, kern, plain = kernels[cls]
            if (cls == "dense" and not side.n_dblocks) or (
                    cls == "quad" and not side.qpanel_segs.numel()) or (
                    cls == "band" and not side.n_coo):
                fail(f"{label}: the {sname} side has no {cls} entry to check")
            got = kern(side, D)
            torch.cuda.synchronize()
            want = plain(side, D) if cls == "chunk" else plain(side, D.double())
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            r = {"max_abs_err": err, "rel_err": err / scale, "scale": scale}
            if not (tuple(got.shape) == (side.rows, k) and math.isfinite(err)
                    and scale > 0 and err <= REL_TOL * scale):
                fail(f"{label} {name} {sname}: error {err} against scale {scale}")
            r["same_bits"] = _same_bits(f"{label} {name} {sname}", lambda: kern(side, D))
            if cls in ("chunk", "quad"):
                r["balance"] = balance(side, cls)
            elif cls == "dense":
                r["pieces"] = {"pieces": side.dpiece_panel.numel(),
                               "split_panels": side.dsplit_panel.numel(),
                               "cap_blocks": int(side.dpiece_ptr.diff().max())}
            if timed:
                A, nnz = _class_csr(side, cls)
                lib = torch.sparse.mm(A, D)
                lerr = float((lib - want).abs().max())
                if not lerr <= 1e-4 * scale:
                    fail(f"{label} {name} {sname}: yardstick disagrees ({lerr})")
                bound_ms, by, nbytes, flops, n_items, core_ms = _bound(side, cls, k, nnz)
                if core_ms is not None:
                    r["bound_ms_cuda_core"] = core_ms
                run, run_plain = lambda: kern(side, D), lambda: plain(side, D)
                if cls == "band":  # into one output, not a new one a call
                    acc = torch.zeros((side.rows, k), device="cuda")
                    run = lambda: S.coo_matmul(side, D, acc)
                    run_plain = lambda: S.coo_matmul_plain(side, D, acc)
                r.update(
                    ms=time_ms(run),
                    plain_ms=time_ms(run_plain, reps=3),
                    library_ms=time_ms(lambda: torch.sparse.mm(A, D), reps=3),
                    bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=flops,
                    nnz=nnz, items=n_items,
                )
                r["mnnz_per_s"] = nnz / r["ms"] / 1e3
                del A, lib
            rec[name][sname] = r
            del got, want
    return rec


def check_split(X, k, label, cls, cap, timed):
    """Kernel 1 (``cls`` "chunk"), 2 ("dense") or 3 ("quad") on both sides
    of ``X`` with its pieces cut again at ``cap`` entries (blocks for kernel
    2), so that most panels are split (the record says how many) and the
    pass that adds their partial panels in piece order runs: against the
    plain version (float64 for kernels 2 and 3) within ``REL_TOL``, the same
    bits twice."""
    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.sparse_format import recut_pieces

    name, kern, plain, cap_name = {
        "chunk": ("chunk_matmul", S.chunk_matmul, S.chunk_matmul_plain, "cap"),
        "dense": ("dense_matmul", S.dense_matmul, S.dense_matmul_plain, "dcap"),
        "quad": ("quad_matmul", S.quad_matmul, S.quad_matmul_plain, "qcap")}[cls]
    gen = torch.Generator(device="cuda").manual_seed(8)
    rec = {}
    for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
        cut = recut_pieces(side, **{cap_name: cap})
        if cls == "dense":
            per_panel = side.dpanel_ptr.diff()
            bal = {"pieces": cut.dpiece_panel.numel(),
                   "split_panels": cut.dsplit_panel.numel(),
                   "panels": int((per_panel > 0).sum()),
                   "max_blocks_in_a_panel": int(per_panel.max())}
        else:
            bal = balance(cut, cls)
        if not bal["split_panels"]:
            fail(f"{label} {name} {sname}: cap {cap} splits no panel")
        D = torch.rand((side.cols, k), generator=gen, device="cuda")
        got = kern(cut, D)
        torch.cuda.synchronize()
        want = plain(side, D if cls == "chunk" else D.double())
        r = _held(f"{label} {name} {sname} cap={cap}", got, want, REL_TOL,
                  (side.rows, k))
        r["same_bits"] = _same_bits(f"{label} {name} {sname} cap={cap}",
                                    lambda: kern(cut, D))
        r.update(cap=cap, balance=bal)
        if timed:
            r["ms"] = time_ms(lambda: kern(cut, D))
        rec[sname] = r
        del got, want, cut
    return rec


def same_bits_products(X, W0, H0):
    """The two products over the store (which has a band) and five HALS
    iterations from one start, each run twice: the same bits, or the run
    fails.  Nothing on the path adds with atomics."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import sparse as S

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {"band_entries": [X.fwd.n_coo, X.bwd.n_coo]}
    for name, fn, rows in (("tiled_mm", S.tiled_mm, N), ("tiled_mtm", S.tiled_mtm, P)):
        D = torch.rand((rows, K), generator=gen, device="cuda")
        out[name] = _same_bits(f"same_bits_products {name}", lambda: fn(X, D))
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, tol=1e-30, maxiter=5)
    a, b = nt.nnmf(X, K, **kw), nt.nnmf(X, K, **kw)
    if not (torch.equal(a.W, b.W) and torch.equal(a.H, b.H)):
        fail("same_bits_products: five HALS iterations from one start gave "
             "different factors in two runs")
    out.update(hals_5_iterations=True, objvalue=a.objvalue)
    return out


def _rel_err(got, want):
    """``max|got - want|`` and ``max|want|``, both as floats."""
    want = want.to(torch.float64)
    return float((got.to(torch.float64) - want).abs().max()), float(want.abs().max())


def _held(label, got, want, tol, shape=None):
    """Record of one kernel held against its plain version; exits when the
    result has the wrong shape, is not finite or differs by more than
    ``tol * max|want|``."""
    err, scale = _rel_err(got, want)
    if shape is not None and tuple(got.shape) != tuple(shape):
        fail(f"{label}: shape {tuple(got.shape)}, expected {tuple(shape)}")
    if not (math.isfinite(err) and scale > 0 and err <= tol * scale):
        fail(f"{label}: error {err} against scale {scale}, limit {tol}")
    return {"max_abs_err": err, "rel_err": err / scale, "scale": scale,
            "tolerance": tol}


def _same_bits(label, fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{label}: two runs gave different bits")
    return True


def check_sddmm(X, W, H, label, timed, cls="chunk"):
    """The sampled-product kernel of one store class (kernel 4 over the
    chunks, kernel 5 over the quad chunks) on the forward side against its
    plain version in float64, and the whole sampled product against
    gather-gather-reduce in float64."""
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.sparse_format import TILE

    Xr, w, h, _ = common.renumbered_problem(X, W, H) if X.row_perm is not None \
        else (X, W, H, None)
    side = Xr.fwd
    k = w.shape[1]
    w32, ht = w.contiguous(), h.T.contiguous()
    if cls == "quad":
        name, kern, plain = "quad_sddmm", S.quad_sddmm, S.quad_sddmm_plain
        n_slots = side.n_qchunks * TILE
        # a sub-segment's entries sit at its front: one count and one row
        # panel a sub-segment, the two coordinates of its entries only, one
        # float out at every slot
        meta_words = (side.qseg_nreal.numel() + side.q_rp.numel()
                      + side.qwin_panel.numel() + side.qwin_stripe.numel())
        n_real = int(side.qseg_nreal.sum())
        slot_bytes = 4 * n_slots + 2 * 4 * n_real
    else:
        name, kern, plain = "chunk_sddmm", S.chunk_sddmm, S.chunk_sddmm_plain
        n_slots = side.coords.numel()
        # a chunk's entries sit at its front: one count a chunk, the
        # coordinates of its entries only, one float out at every slot
        meta_words = side.chunk_nreal.numel() + side.win_panel.numel() + side.win_stripe.numel()
        n_real = int(side.chunk_nreal.sum())
        slot_bytes = 4 * n_slots + 4 * n_real
    if not n_slots:
        fail(f"{label}: the store has no {cls} slot to sample")
    got = kern(side, w32, ht)
    torch.cuda.synchronize()
    want = plain(side, w32.double(), ht.double())
    r = _held(f"{label} {name}", got, want, REL_TOL, (n_slots,))
    r["same_bits"] = _same_bits(f"{label} {name}", lambda: kern(side, w32, ht))
    del got, want

    # the whole product, in the caller's coordinates, permutations included
    whole = S.tiled_sddmm(X, W, H)
    Wd, Htd = W.double(), H.double().T.contiguous()
    err = scale = 0.0
    step = 1 << 19
    for e0 in range(0, X.nnz, step):
        sl = slice(e0, e0 + step)
        ref = (Wd[X.row_idx[sl].long()] * Htd[X.col_idx[sl].long()]).sum(dim=1)
        e, sc = _rel_err(whole[sl], ref)
        err, scale = max(err, e), max(scale, sc)
    if not (tuple(whole.shape) == (X.nnz,) and math.isfinite(err)
            and err <= REL_TOL * scale):
        fail(f"{label} tiled_sddmm: error {err} against scale {scale}")
    r["tiled_sddmm_rel_err"] = err / scale
    del whole, Wd, Htd

    if timed:
        A, nnz = _class_csr(side, cls)
        h32 = h.contiguous()
        lib = torch.sparse.sampled_addmm(A, w32, h32, beta=0.0)
        rows = torch.repeat_interleave(
            torch.arange(side.rows, device="cuda"), A.crow_indices().diff())
        ref = (w32.double()[rows] * ht.double()[A.col_indices()]).sum(dim=1)
        lerr, lscale = _rel_err(lib.values(), ref)
        if not lerr <= 1e-4 * lscale:
            fail(f"{label} {name}: yardstick disagrees ({lerr})")
        del rows, ref, lib
        # the function's own traffic: the slots' coordinates and outputs,
        # the metadata and both factors
        nbytes = slot_bytes + 4 * meta_words + 4 * k * (side.rows + side.cols)
        flops = 2 * nnz * k
        bound_ms, by = bound_of(nbytes, flops)
        r.update(
            ms=time_ms(lambda: kern(side, w32, ht)),
            plain_ms=time_ms(lambda: plain(side, w32, ht), reps=3),
            library_ms=time_ms(
                lambda: torch.sparse.sampled_addmm(A, w32, h32, beta=0.0), reps=3),
            tiled_sddmm_ms=time_ms(lambda: S.tiled_sddmm(X, W, H), reps=3),
            bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=flops, nnz=nnz,
            slots=n_slots,
            # read by the kernel on top of the floor: the refresh map at
            # the real slots and a W panel a piece
            extra_bytes=4 * n_real + 4 * k * TILE * (
                side.piece_panel if cls == "chunk" else side.qpiece_panel).numel(),
        )
        r["mnnz_per_s"] = nnz / r["ms"] / 1e3
    return r


def check_dense_kernels(X, W, H, label, timed):
    """Kernels 6 (both kinds), 7 (both orientations), 8 and 9 against their
    plain versions run in float64 on the card."""
    return {**check_quotients(X, W, H, label, timed, sweep=timed),
            "dense_objective": check_objective(X, W, H, label, timed, sweep=timed),
            "mu_factor_update": check_factor_update(X, W, H, label, timed, sweep=timed)}


def check_quotients(X, W, H, label, timed, sweep=False, graph=False):
    """Kernels 8 and 9 against their plain versions run in float64 on the
    card; with ``sweep``, also timed with their walks cut into other numbers
    of runs than the wrapper's rule picks (the evidence for that rule); with
    ``graph``, their device times by ``graph_ms``."""
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    p, n = X.shape
    k = W.shape[1]
    delta = sqrt_eps(torch.float32)
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    rec = {}
    for name, fn, plain, shape in (("wtq", M.wtq, M.wtq_plain, (k, n)),
                                   ("qht", M.qht, M.qht_plain, (p, k))):
        got = fn(X, W, H, delta)
        torch.cuda.synchronize()
        r = _held(f"{label} {name}", got, plain(Xd, Wd, Hd, delta), REL_TOL, shape)
        r["same_bits"] = _same_bits(f"{label} {name}", lambda: fn(X, W, H, delta))
        if timed:
            bound_ms, by = bound_of(4 * (p * n + p * k + k * n + shape[0] * shape[1]),
                                    4 * p * n * k + 2 * p * n)
            r.update(ms=time_ms(lambda: fn(X, W, H, delta)),
                     plain_ms=time_ms(lambda: plain(X, W, H, delta), reps=3),
                     bound_ms=bound_ms, bound_by=by)
            r["library_ms"] = r["plain_ms"]  # the one expression is the plain version
        if graph:
            r["graph_ms"] = graph_ms(lambda: fn(X, W, H, delta))
        if sweep:
            rule = M.walk_splits
            r["runs"] = rule(shape[1] if name == "wtq" else shape[0],
                             p if name == "wtq" else n, k,
                             torch.cuda.get_device_properties(X.device).multi_processor_count,
                             M.QT_EDGE)
            r["ms_by_runs"] = {}
            try:
                for runs in (1, 2, 4, 8, 16, 33, 66):
                    M.walk_splits = lambda *a, runs=runs: runs
                    r["ms_by_runs"][runs] = time_ms(lambda: fn(X, W, H, delta), reps=3)
            finally:
                M.walk_splits = rule
        rec[name] = r
        del got
    return rec


def check_objective(X, W, H, label, timed, sweep=False):
    """Kernel 6 (both kinds) against its plain version run in float64 on
    the card, within ``OBJECTIVE_TOL``; with ``sweep``, also timed with its
    walk cut into other numbers of runs than the wrapper's."""
    from nmf_tpu_torch.ops.cuda import objectives as O

    p, n = X.shape
    k = W.shape[1]
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    rec = {}
    for kind, fn in (("mse", O.mse_objective_kernel), ("kl", O.kl_objective_kernel)):
        got = fn(X, W, H)
        torch.cuda.synchronize()
        want = O.dense_objective_plain(Xd, Wd, Hd, kind)
        r = _held(f"{label} objective {kind}", got.reshape(1), want.reshape(1), OBJECTIVE_TOL)
        r["value"] = float(got)
        r["same_bits"] = _same_bits(f"{label} objective {kind}", lambda: fn(X, W, H))
        if timed:
            logs = p * n if kind == "kl" else 0
            bound_ms, by = bound_of(4 * (p * n + p * k + k * n),
                                    2 * p * n * k + 4 * p * n + logs)
            r.update(ms=time_ms(lambda: fn(X, W, H)),
                     plain_ms=time_ms(lambda: O.dense_objective_plain(X, W, H, kind), reps=3),
                     bound_ms=bound_ms, bound_by=by)
            r["library_ms"] = r["plain_ms"]  # column blocks of W @ H, one reduction each
        if sweep:
            rule = O.objective_splits
            r["runs"] = rule(p, n, torch.cuda.get_device_properties(X.device)
                             .multi_processor_count)
            r["ms_by_runs"] = {}
            try:
                for runs in (1, 8, 16, 33, 66, 132):
                    O.objective_splits = lambda *a, runs=runs: runs
                    r["ms_by_runs"][runs] = time_ms(lambda: fn(X, W, H), reps=3)
            finally:
                O.objective_splits = rule
        rec[kind] = r
    return rec


def check_factor_update(X, W, H, label, timed, sweep=False, graph=False):
    """Kernel 7 as the H step and as the W step of the MSE sweep call it,
    against its plain version run in float64 on the card; with ``sweep``,
    also timed at every tile width it has (the evidence for the wrapper's
    rule, ``mu_tiling``); with ``graph``, its device time by ``graph_ms``."""
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    k = W.shape[1]
    delta = sqrt_eps(torch.float32)
    lam = 0.01
    rec = {}
    G_h, C_h = W.T @ W, W.T @ X
    G_w, C_w = H @ H.T, X @ H.T
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    for side, F, G, C in (("H", H, G_h, C_h), ("W", W.T, G_w, C_w.T)):
        run = lambda: M.mu_factor_update(F, G, C, lam, delta)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        want = M.mu_factor_update_plain(F.double(), G.double(), C.double(), lam, delta)
        r = _held(f"{label} mu_factor_update {side}", got, want, REL_TOL, F.shape)
        if got.stride() != F.stride():
            fail(f"{label} mu_factor_update {side}: result layout differs from F's")
        r["same_bits"] = _same_bits(f"{label} mu_factor_update {side}", run)
        r["tiling"] = M.mu_tiling(k, F.shape[1], sms)
        if timed:
            m = F.shape[1]
            bound_ms, by = bound_of(4 * (3 * k * m + k * k), 2 * k * k * m + 4 * k * m)
            r.update(ms=time_ms(run),
                     plain_ms=time_ms(lambda: M.mu_factor_update_plain(F, G, C, lam, delta)),
                     bound_ms=bound_ms, bound_by=by)
            r["library_ms"] = r["plain_ms"]  # the plain expression
        if graph:
            r["graph_ms"] = graph_ms(run)
        if sweep and k <= M.MU_SLAB:
            rule = M.mu_tiling
            r["ms_by_width"] = {}
            try:
                for w in M.MU_WIDTHS:
                    M.mu_tiling = lambda k_, m_, n_, w=w: rule(k_, m_, n_, w)
                    if not torch.equal(run(), got):
                        fail(f"{label} mu_factor_update {side}: tiles of {w} gave other bits")
                    r["ms_by_width"][w] = time_ms(run, reps=3)
            finally:
                M.mu_tiling = rule
        rec[side] = r
    return rec


def check_quotient_edges():
    """Kernels 8, 9 and 6 (both kinds), which share one tile routine, at the
    edges of their tiles, against their plain versions in float64 within
    ``REL_TOL``, the same bits twice: p and n no multiple of the tile edges,
    at 1,001 x 777 (n % 4 != 0: 4-byte copies of X and H), at 1,001 x 776
    (16-byte copies) and with that X as a view one float past a 16-byte
    boundary (xvec = 0); k from 1 to past two slabs (1, 9, 63, 65, 129:
    4-byte copies of W; 64, 128: 16-byte ones).  X has exact zeros (the KL
    term's x = 0 branch)."""
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.ops.cuda import objectives as O

    gen = torch.Generator(device="cuda").manual_seed(8)
    delta = 3.45e-4
    out = {}
    for p, n, shift in ((1001, 777, 0), (1001, 776, 0), (1001, 776, 1)):
        X = torch.rand(p * n + shift, generator=gen, device="cuda")[shift:].view(p, n)
        X[X < 0.1] = 0.0
        for k in (1, 9, 63, 64, 65, 128, 129):
            W = torch.rand((p, k), generator=gen, device="cuda")
            H = torch.rand((k, n), generator=gen, device="cuda")
            xvec = M.check_dense_problem(X, W, H, "wtq")[5]
            if xvec != int(shift == 0 and n % 4 == 0):
                fail(f"edges {p}x{n}+{shift}: xvec {xvec}")
            Xd, Wd, Hd = X.double(), W.double(), H.double()
            r = {"xvec": xvec}
            for name, fn, plain, shape in (("wtq", M.wtq, M.wtq_plain, (k, n)),
                                           ("qht", M.qht, M.qht_plain, (p, k))):
                label = f"edges {name} {p}x{n}+{shift} k={k}"
                r[name] = _held(label, fn(X, W, H, delta), plain(Xd, Wd, Hd, delta),
                                REL_TOL, shape)["rel_err"]
                _same_bits(label, lambda: fn(X, W, H, delta))
            for kind, fn in (("mse", O.mse_objective_kernel), ("kl", O.kl_objective_kernel)):
                label = f"edges objective {kind} {p}x{n}+{shift} k={k}"
                r[f"objective_{kind}"] = _held(
                    label, fn(X, W, H).reshape(1),
                    O.dense_objective_plain(Xd, Wd, Hd, kind).reshape(1), REL_TOL)["rel_err"]
                _same_bits(label, lambda: fn(X, W, H))
            out[f"{p}x{n}+{shift}_k{k}"] = r
    return out


def check_sddmm_edges(rs, cs, vs, shape):
    """Kernels 4 and 5 at their edges, against their plain versions in
    float64 within ``REL_TOL`` at every slot, exactly 0 at padding slots,
    the same bits twice and with the pieces cut at 128 (kernel 4) or 64
    (kernel 5) entries: k below and above a lane's 16 floats (1, 3, 16, 17,
    127, 128, 129), both sides of the W panel they stage (191, 193) and
    above a sparse product's slab (450, 451); kernel 4 on the small chunk
    store and on wide tail tiles (span 4), kernel 5 on the small quad store
    at seg 32 and 16; both on a store that is nearly all padding (about
    five entries a tile, some 390 chunks a row panel)."""
    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.sparse_format import build_tiled, recut_pieces

    rng = np.random.default_rng(9)
    p, n = 200, 50_000
    key = np.unique(rng.integers(0, p, 3000) * n + rng.integers(0, n, 3000))
    wide = ((key // n).astype(np.int32), (key % n).astype(np.int32),
            (rng.random(len(key)) + 0.5).astype(np.float32), (p, n))
    stage = S.SDDMM_STAGE_K
    chunk_ks = (1, 3, 127, 128, 129, stage + 1, 451)
    quad_ks = (1, 16, 17, 128, 129, stage - 1, stage + 1, 450)
    # tag: (store, kernel 5?, the k it is held at)
    stores = {
        "small": (build_tiled(rs, cs, vs, shape, dense_tile_nnz=192, coo_tail_nnz=3),
                  False, chunk_ks),
        "span4": (build_tiled(rs, cs, vs, shape, dense_tile_nnz=192, tail_span=4,
                              coo_tail_nnz=3), False, chunk_ks),
        "wide_padding": (build_tiled(*wide, order="natural"), False, chunk_ks),
        "quad32": (build_tiled(rs, cs, vs, shape, dense_tile_nnz=192, quad_tail_nnz=32),
                   True, quad_ks),
        "quad16": (build_tiled(rs, cs, vs, shape, dense_tile_nnz=192, quad_tail_nnz=16,
                               quad_seg=16), True, quad_ks),
        "quad_wide_padding": (build_tiled(*wide, quad_tail_nnz=32, order="natural"),
                              True, quad_ks),
    }
    gen = torch.Generator(device="cuda").manual_seed(10)
    out = {}
    for tag, (X, quad, ks) in stores.items():
        side = X.fwd
        if quad:
            kern, plain, name = S.quad_sddmm, S.quad_sddmm_plain, "quad_sddmm"
            pad = side.qinv >= side.perm.shape[0]
            cut = recut_pieces(side, qcap=64)
        else:
            kern, plain, name = S.chunk_sddmm, S.chunk_sddmm_plain, "chunk_sddmm"
            pad = side.inv >= side.perm.shape[0]
            cut = recut_pieces(side, 128)
        r = {"kernel": name, "padding_share": float(pad.float().mean())}
        for k in ks:
            W = torch.rand((side.rows, k), generator=gen, device="cuda")
            Ht = torch.rand((side.cols, k), generator=gen, device="cuda")
            label = f"sddmm edges {tag} k={k}"
            got = kern(side, W, Ht)
            r[k] = _held(label, got, plain(side, W.double(), Ht.double()), REL_TOL)["rel_err"]
            if got[pad].any():
                fail(f"{label}: a padding slot is not 0")
            _same_bits(label, lambda: kern(side, W, Ht))
            if not torch.equal(got, kern(cut, W, Ht)):
                fail(f"{label}: other pieces gave other bits")
        out[tag] = r
    return out


def _rel_each(got, want):
    """Largest ``|got - want| / |want|`` over the entries, in float64."""
    want = want.to(torch.float64)
    return float(((got.to(torch.float64) - want).abs() / want.abs()).max())


def check_elementwise(shape, timed, gen):
    """Kernels 10-12 at one shape: ``projectnn`` bit for bit against its
    plain version, the column sums and the scaling within ``EW_REL_TOL``
    of each entry of their plain versions run in float64, the scaling also
    bit for bit against the float32 division given the same sums."""
    from nmf_tpu_torch.ops.cuda import elementwise as E

    m, n = shape
    label = f"elementwise {m}x{n}"
    A = torch.randn(shape, generator=gen, device="cuda")
    Apos = A.abs() + 0.1
    rec = {}

    got = E.projectnn(A)
    torch.cuda.synchronize()
    want = E.projectnn_plain(A)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{label} projectnn: not bit-equal to its plain version")
    rec["projectnn"] = {
        "max_abs_err": float((got - want).abs().max()), "bit_equal": True,
        "same_bits": _same_bits(f"{label} projectnn", lambda: E.projectnn(A)),
        "bit_equal_to_clamp_min": torch.equal(
            got.view(torch.int32), A.clamp_min(0).view(torch.int32)),
    }
    s = E.colsum(Apos)
    torch.cuda.synchronize()
    r = _held(f"{label} colsum", s, E.colsum_plain(Apos.double()), EW_REL_TOL, (n,))
    r["max_rel_err_each"] = _rel_each(s, E.colsum_plain(Apos.double()))
    if not r["max_rel_err_each"] <= EW_REL_TOL:
        fail(f"{label} colsum: {r['max_rel_err_each']} relative to float64")
    r["same_bits"] = _same_bits(f"{label} colsum", lambda: E.colsum(Apos))
    rec["colsum"] = r
    out = E.scale_cols(Apos, s)
    torch.cuda.synchronize()
    want = E.scale_cols_plain(Apos.double(), E.colsum_plain(Apos.double()))
    r = _held(f"{label} scale_cols", out, want, EW_REL_TOL, shape)
    r["max_rel_err_each"] = _rel_each(out, want)
    if not r["max_rel_err_each"] <= EW_REL_TOL:
        fail(f"{label} scale_cols: {r['max_rel_err_each']} relative to float64")
    if not torch.equal(out, E.scale_cols_plain(Apos, s)):
        fail(f"{label} scale_cols: not the bits of the float32 division")
    r["same_bits"] = _same_bits(f"{label} scale_cols", lambda: E.scale_cols(Apos, s))
    rec["scale_cols"] = r
    if timed:
        # bytes: each input read once, each output written once; operations:
        # one compare, one add (in double) or one division an entry
        for name, fn, plain, lib, nbytes in (
            ("projectnn", lambda: E.projectnn(A), lambda: E.projectnn_plain(A),
             lambda: A.clamp_min(0), 8 * m * n),
            ("colsum", lambda: E.colsum(Apos), lambda: E.colsum_plain(Apos),
             lambda: Apos.sum(0), 4 * m * n + 4 * n),
            ("scale_cols", lambda: E.scale_cols(Apos, s),
             lambda: E.scale_cols_plain(Apos, s), lambda: Apos / s, 8 * m * n + 4 * n),
        ):
            bound_ms, by = bound_of(nbytes, m * n)
            rec[name].update(ms=time_ms(fn), plain_ms=time_ms(plain),
                             library_ms=time_ms(lib), bound_ms=bound_ms,
                             bound_by=by, bytes=nbytes)
    return rec


def start_two_pass_colsum_build():
    """``nvcc`` on ``tools/colsum_two_pass.cu`` (kernel 11's two-pass
    design, which the one-launch kernel replaced), started now and awaited by
    ``load_two_pass_colsum``: the measurement the redesign starts from."""
    from nmf_tpu_torch.ops.cuda import build

    build.BUILD.mkdir(parents=True, exist_ok=True)
    target = build.BUILD / "libcolsum_two_pass.so"
    src = pathlib.Path(__file__).resolve().parent / "tools" / "colsum_two_pass.cu"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(target), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, target


def load_two_pass_colsum(started):
    import ctypes

    proc, target = started
    log = proc.communicate()[0]
    if proc.returncode:
        fail(f"nvcc failed on tools/colsum_two_pass.cu:\n{log}")
    lib = ctypes.CDLL(str(target))
    for fn in (lib.two_pass_colsum_partial, lib.two_pass_colsum_finish):
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _ulps_off(got, want):
    """Largest distance, in float32 ulps, of ``got`` (float32) from ``want``
    (float64) rounded to float32; both of one sign (the sums of positive
    entries)."""
    a = got.contiguous().view(torch.int32).to(torch.int64)
    b = want.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return int((a - b).abs().max())


COLSUM_EDGE_M = (1, 1000, 9973, P + 1)
COLSUM_EDGE_N = (1, 3, 4, 127, 128, 450, 512)


def check_colsum(lib, gen):
    """Kernel 11 at its edges and at the path's shape.  Edges: m of 1, 1,000
    (fewer rows than a block an SM), 9,973 and 163,001 (ragged) by n of
    1, 3, 4, 127, 128, 450 and 512, and a misaligned A (the one-column
    loads): each column within 1 ulp of the float64 sum, the same bits twice
    and from two streams at once.  At 163,000 x 128: ``ms``, ``graph_ms``,
    the bound, ``sum(0)``, the two-pass design's passes each alone and together
    (``tools/colsum_two_pass.cu``), and ``normalize1_cols`` (kernels 11 and 12)
    end to end."""
    from nmf_tpu_torch.ops.cuda import elementwise as E
    from nmf_tpu_torch.utils import numeric

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    edges = {}
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for m in COLSUM_EDGE_M:
        for n in COLSUM_EDGE_N:
            A = torch.rand((m, n), generator=gen, device="cuda")
            edges[f"{m}x{n}"] = _colsum_edge(E, A, side)
    base = torch.rand(9973 * 128 + 1, generator=gen, device="cuda")
    edges["9973x128_misaligned"] = _colsum_edge(E, base[1:].view(9973, 128), side)
    if edges["9973x128_misaligned"]["vec"]:
        fail("colsum: a misaligned A took the 16-byte loads")
    worst = max(r["ulps"] for r in edges.values())

    m, n = P, K
    A = torch.rand((m, n), generator=gen, device="cuda") + 0.1
    got = E.colsum(A)
    want = A.double().sum(0)
    if _ulps_off(got, want) > 1:
        fail("colsum 163000x128: more than 1 ulp from the float64 sum")
    nb = -(-m // 256)
    partial = torch.empty((nb, n), dtype=torch.float64, device="cuda")
    old = torch.empty(n, device="cuda")

    def two_pass(which):
        stream = torch.cuda.current_stream().cuda_stream  # a graph captures on its own
        if which in ("partial", "both") and lib.two_pass_colsum_partial(
                A.data_ptr(), partial.data_ptr(), m, n, stream):
            fail("the two-pass colsum's partial pass failed to launch")
        if which in ("finish", "both") and lib.two_pass_colsum_finish(
                partial.data_ptr(), old.data_ptr(), m, n, stream):
            fail("the two-pass colsum's finish pass failed to launch")

    two_pass("both")
    torch.cuda.synchronize()
    plan = E.colsum_plan(m, n, sms)
    nbytes = 4 * m * n + 4 * n
    bound_ms, by = bound_of(nbytes, m * n)
    rec = {
        "shape": [m, n], "plan": plan._asdict(), "ulps_two_pass": _ulps_off(old, want),
        "ms": time_ms(lambda: E.colsum(A), reps=11),
        "graph_ms": graph_ms(lambda: E.colsum(A)),
        "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
        "library_ms": time_ms(lambda: A.sum(0), reps=11),
        "two_pass_ms": time_ms(lambda: two_pass("both"), reps=11),
        "two_pass_partial_ms": time_ms(lambda: two_pass("partial"), reps=11),
        "two_pass_finish_ms": time_ms(lambda: two_pass("finish"), reps=11),
        "two_pass_graph_ms": graph_ms(lambda: two_pass("both")),
        "normalize1_cols_ms": time_ms(lambda: numeric.normalize1_cols(A), reps=11),
        "normalize1_cols_graph_ms": graph_ms(lambda: numeric.normalize1_cols(A)),
    }
    return {"edges": edges, "max_ulps": worst, "path_shape": rec}


def _colsum_edge(E, A, streams):
    m, n = A.shape
    want = A.double().sum(0)
    got = E.colsum(A)
    torch.cuda.synchronize()
    ulps = _ulps_off(got, want)
    if tuple(got.shape) != (n,) or ulps > 1:
        fail(f"colsum {m}x{n}: {ulps} ulps from the float64 sum")
    _same_bits(f"colsum {m}x{n}", lambda: E.colsum(A))
    outs = []
    for st in streams:  # both in flight at once, each with its own scratch
        with torch.cuda.stream(st):
            outs.append(E.colsum(A))
    torch.cuda.synchronize()
    if not all(torch.equal(o, got) for o in outs):
        fail(f"colsum {m}x{n}: another stream gave other bits")
    return {"ulps": ulps, "vec": bool(n % 4 == 0 and A.data_ptr() % 16 == 0)}


def sparse_sums(X, rows, cols, vals):
    """``matops.colsums`` / ``rowsums`` on the chunk store (its products
    against a ones column, kernels 1-3 and the band): within ``REL_TOL`` of
    ``max|want|`` of the float64 sums, the same bits twice; timed beside
    ``index_add_`` over the CSR-order values, the atomics they replace."""
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import build

    out = {}
    for name, fn, idx, size in (("colsums", matops.colsums, cols, N),
                                ("rowsums", matops.rowsums, rows, P)):
        want = torch.from_numpy(np.bincount(idx, weights=vals.astype(np.float64),
                                            minlength=size)).cuda()
        build.reset_launch_counts()
        got = fn(X)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.launch_counts().items() if v}
        r = _held(f"sparse_sums {name}", got, want, REL_TOL, (size,))
        r["same_bits"] = _same_bits(f"sparse_sums {name}", lambda: fn(X))
        ix = torch.from_numpy(idx.astype(np.int64)).cuda()
        v = torch.from_numpy(vals).cuda()
        r.update(launches=launches, ms=time_ms(lambda: fn(X)),
                 index_add_ms=time_ms(lambda: v.new_zeros(size).index_add_(0, ix, v)))
        out[name] = r
        del ix, v
    return out


def precision(Xd):
    """The caller turns TF32 on through the legacy API
    (``torch.set_float32_matmul_precision("high")``): a dense HALS solve of
    three iterations and ``nnmf(Xd, 64, maxiter=5)`` with its defaults give
    the bits they give under ``"highest"``; inside the solves cuBLAS reads
    ``"ieee"`` (recorded at every ``matops.mm``); afterwards
    ``torch.get_float32_matmul_precision()`` reads ``"high"`` again.  A bare
    product outside any solve shows that the caller's setting is live."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import matops

    seen = []
    mm = matops.mm

    def recording_mm(X, D):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return mm(X, D)

    runs = {
        "hals_3": lambda: nt.nnmf(Xd, DK, alg="cd", init="random", maxiter=3),
        "nnmf_defaults_5": lambda: nt.nnmf(Xd, DK, maxiter=5),
    }
    Hp = torch.rand((DN, DK), device="cuda")
    out = {}
    results = {}
    for setting in ("highest", "high"):
        torch.set_float32_matmul_precision(setting)
        matops.mm = recording_mm
        try:
            results[setting] = {name: run() for name, run in runs.items()}
        finally:
            matops.mm = mm
        torch.cuda.synchronize()
        out[setting] = {"after": torch.get_float32_matmul_precision(),
                        "inside": sorted(set(seen))}
        seen.clear()
        if out[setting]["after"] != setting:
            fail(f"precision: the caller's {setting!r} read "
                 f"{out[setting]['after']!r} after the solves")
        if out[setting]["inside"] != ["ieee"]:
            fail(f"precision: under {setting!r} a solve ran at {out[setting]['inside']}")
        results[setting]["bare"] = Xd @ Hp
    torch.set_float32_matmul_precision("highest")
    for name in runs:
        a, b = results["highest"][name], results["high"][name]
        if not (torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
                and a.objvalue == b.objvalue):
            fail(f"precision: {name} gave other bits under 'high'")
        out[name] = {"same_bits": True, "objvalue": a.objvalue, "niters": a.niters}
    out["bare_product_differs_under_high"] = not torch.equal(
        results["highest"]["bare"], results["high"]["bare"])
    return out


def check_k_ceilings(rs, cs, vs, shape):
    """Every k that a kernel refused before it summed over k in slabs, at a
    small shape, against the plain version in float64 within ``REL_TOL``:
    the dense multiplicative-update kernels and the objective at one past
    each old ceiling (182, 372, 436) and at 512; the chunk and quad products
    at 451 (one past their earlier panel's 450), at one past their panel's
    ``MAX_K`` and at 512, where the whole product runs in column slabs; the
    dense-tile kernel alone at all of these k, also the same bits twice."""
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.ops.cuda import objectives as O
    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.sparse_format import build_tiled

    out = {"dense": {}, "sparse": {}}
    gen = torch.Generator(device="cuda").manual_seed(6)
    delta = 3.45e-4
    for k in (183, 373, 437, 512):
        X = torch.rand((300, 260), generator=gen, device="cuda")
        W = torch.rand((300, k), generator=gen, device="cuda")
        H = torch.rand((k, 260), generator=gen, device="cuda")
        Xd, Wd, Hd = X.double(), W.double(), H.double()
        r = {}
        for name, fn, plain in (("wtq", M.wtq, M.wtq_plain), ("qht", M.qht, M.qht_plain)):
            r[name] = _held(f"k_ceilings {name} k={k}", fn(X, W, H, delta),
                            plain(Xd, Wd, Hd, delta), REL_TOL)["rel_err"]
        for side, F, G, C in (("H", H, W.T @ W, W.T @ X), ("W", W.T, H @ H.T, (X @ H.T).T)):
            got = M.mu_factor_update(F, G, C, 0.01, delta)
            want = M.mu_factor_update_plain(F.double(), G.double(), C.double(), 0.01, delta)
            lab = f"k_ceilings mu_factor_update {side} k={k}"
            r[f"mu_factor_update_{side}"] = _held(lab, got, want, REL_TOL)["rel_err"]
            _same_bits(lab, lambda: M.mu_factor_update(F, G, C, 0.01, delta))
        for kind, fn in (("mse", O.mse_objective_kernel), ("kl", O.kl_objective_kernel)):
            lab = f"k_ceilings objective {kind} k={k}"
            r[f"objective_{kind}"] = _held(
                lab, fn(X, W, H).reshape(1),
                O.dense_objective_plain(Xd, Wd, Hd, kind).reshape(1), REL_TOL)["rel_err"]
            _same_bits(lab, lambda: fn(X, W, H))
        out["dense"][k] = r
    Xdense = torch.zeros(shape, dtype=torch.float64, device="cuda")
    Xdense[torch.from_numpy(rs).long().cuda(), torch.from_numpy(cs).long().cuda()] = \
        torch.from_numpy(vs).double().cuda()
    for tag, opts in (("chunk", dict(dense_tile_nnz=192, coo_tail_nnz=3)),
                      ("quad", dict(dense_tile_nnz=192, quad_tail_nnz=32))):
        Xs = build_tiled(rs, cs, vs, shape, **opts)
        for k in sorted({451, S.MAX_K + 1, 512}):
            D = torch.rand((shape[1], k), generator=gen, device="cuda")
            D2 = torch.rand((shape[0], k), generator=gen, device="cuda")
            build.reset_launch_counts()
            r = {"mm": _held(f"k_ceilings {tag} mm k={k}", S.tiled_mm(Xs, D),
                             Xdense @ D.double(), REL_TOL)["rel_err"],
                 "mtm": _held(f"k_ceilings {tag} mtm k={k}", S.tiled_mtm(Xs, D2),
                              Xdense.T @ D2.double(), REL_TOL)["rel_err"]}
            r["launches"] = {n_: c for n_, c in build.launch_counts().items() if c}
            slabs = 2 * -(-k // S.MAX_K)
            if r["launches"].get("chunk_matmul") != slabs or (
                    tag == "quad" and r["launches"].get("quad_matmul") != slabs):
                fail(f"k_ceilings {tag} k={k}: launches {r['launches']}, "
                     f"expected {slabs} slabs")
            out["sparse"][f"{tag}_k{k}"] = r
        if tag == "chunk":
            # kernel 2 alone takes any k (a thread block a 128-column slice)
            out["dense_matmul"] = {}
            for k in (183, 373, 437, 451, S.MAX_K + 1, 512):
                r = {}
                for sname, side in (("fwd", Xs.fwd), ("bwd", Xs.bwd)):
                    D = torch.rand((side.cols, k), generator=gen, device="cuda")
                    lab = f"k_ceilings dense_matmul {sname} k={k}"
                    r[sname] = _held(lab, S.dense_matmul(side, D),
                                     S.dense_matmul_plain(side, D.double()),
                                     REL_TOL)["rel_err"]
                    _same_bits(lab, lambda: S.dense_matmul(side, D))
                out["dense_matmul"][k] = r
        del Xs
    return out


# ---------------------------------------------------------------------------
# the main path


def relerr_of(X, W, H, xsq):
    from nmf_tpu_torch.ops.objectives import mse_objective

    obj = float(mse_objective(X, W, H))
    return obj, math.sqrt(max(2.0 * obj, 0.0)) / math.sqrt(xsq)


def small_problem_check():
    """5 HALS iterations on a small power-law problem: the tiled store
    through the kernels against the same matrix held dense (cuBLAS path)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.sparse_format import build_tiled

    rng = np.random.default_rng(5)
    p, n, k = 3000, 2500, 16
    rows, cols, vals = _movielens_like(rng, p, n, 400_000)
    X = build_tiled(rows, cols, vals, (p, n), dense_tile_nnz=192, coo_tail_nnz=3)
    Xd = np.zeros((p, n), np.float32)
    Xd[rows, cols] = vals
    W0 = rng.random((p, k), dtype=np.float32)
    H0 = rng.random((k, n), dtype=np.float32)
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, tol=1e-30, maxiter=5)
    a = nt.nnmf(X, k, **kw)
    b = nt.nnmf(Xd, k, **kw)
    for name, x, y in (("W", a.W, b.W), ("H", a.H, b.H)):
        # f32 sums in another order, fed back through 5 sweeps: held in norm
        rel = float((x - y).norm() / y.norm())
        if not rel <= 1e-3:
            fail(f"small problem: {name} differs between tiled and dense X "
                 f"by {rel} of its norm")
    if not abs(a.objvalue - b.objvalue) <= 1e-4 * abs(b.objvalue):
        fail(f"small problem: objective {a.objvalue} vs {b.objvalue}")
    return {"objvalue_tiled": a.objvalue, "objvalue_dense": b.objvalue,
            "nnz": len(vals)}


def solve_main_path(X, W0, H0, alg, upd, max_iters, must_reach):
    """One solver on the full store: 5 traced iterations through ``nnmf``,
    then the resumable loop from the same start in chunks of 5 until the
    target relative error or ``max_iters``.  ``must_reach`` makes a missed
    target a failure; otherwise the count is reported and no limit is set on
    it.  Returns the record and the last factors (renumbered coordinates)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import common

    out = {}
    xsq = float(X.stats[1])

    # (a) through the front door, 5 traced iterations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nt.nnmf(X, K, alg=alg, init="custom", W0=W0, H0=H0, tol=1e-30,
                  maxiter=5, trace=True)
    torch.cuda.synchronize()
    out["nnmf_5_traced_iters_s"] = time.perf_counter() - t0
    hist = res.trace.objvalue.tolist()
    out["nnmf_objective_history"] = hist
    if not (tuple(res.W.shape) == (P, K) and tuple(res.H.shape) == (K, N)
            and res.niters == 5 and not res.converged
            and bool(torch.isfinite(res.W).all())
            and bool(torch.isfinite(res.H).all())
            and bool((res.W >= 0).all()) and bool((res.H >= 0).all())):
        fail(f"nnmf returned a bad result: {res}")
    if not abs(hist[-1] - res.objvalue) <= 1e-5 * abs(res.objvalue):
        fail("nnmf: last traced objective differs from objvalue")

    # (b) the resumable loop from the same start, in chunks of 5, one
    # relative-error read per chunk, until the target
    Xr, w, h, perms = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    )
    state = common._prepare(upd, Xr, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 0
    obj, r = relerr_of(Xr, w, h, xsq)
    traj = [(0, obj, r)]
    while not r <= TARGET_RELERR and iters < max_iters:
        w, h, state, t, _, _ = common._solve_while_from(
            upd, state, Xr, w, h, 0, 5, 1e-30, with_objective=False
        )
        iters += t
        obj, r = relerr_of(Xr, w, h, xsq)
        traj.append((iters, obj, r))
        if iters == 5:
            if not abs(obj - res.objvalue) <= 1e-4 * abs(res.objvalue):
                fail(f"resumable loop and nnmf disagree after 5 iterations: "
                     f"{obj} vs {res.objvalue}")
    torch.cuda.synchronize()
    out["seconds_to_target"] = time.perf_counter() - t0
    out["iterations"] = iters
    out["final_relerr"] = r
    out["trajectory"] = traj
    out["seconds_per_iteration"] = out["seconds_to_target"] / max(iters, 1)
    objs = hist + [o for _, o, _ in traj[1:]]
    for prev, cur in zip([traj[0][1]] + hist[:-1], hist):
        if cur > prev * (1 + 1e-4):
            fail(f"objective rose inside nnmf: {prev} -> {cur}")
    for (_, prev, _), (_, cur, _) in zip(traj, traj[1:]):
        if cur > prev * (1 + 1e-4):
            fail(f"objective rose in the resumable loop: {prev} -> {cur}")
    if not all(math.isfinite(o) for o in objs):
        fail("non-finite objective")
    out["reached_target"] = r <= TARGET_RELERR
    if must_reach and not r <= TARGET_RELERR:
        fail(f"relative error {r} after {iters} iterations, target {TARGET_RELERR}")
    return out, (Xr, w, h)


@contextlib.contextmanager
def counted_masked_steps(active_sums=False):
    """Counts GreedyCD's masked steps while the block runs: yields a list
    that gets ``[rows, steps, sum of the active rows over the steps]`` for
    every half-step.  The counts read nothing back to the host; the sums
    (``active_sums``) add one device sum a step."""
    from nmf_tpu_torch.models import greedycd as G

    log = []
    step, rows_fn = G._masked_step, G._greedy_rows

    def counted_step(W, c, active, *a):
        log[-1][1] += 1
        if active_sums:
            log[-1][2] += active.sum()
        return step(W, c, active, *a)

    def counted_rows(W, *a):
        log.append([W.shape[:-1].numel(), 0,
                    torch.zeros((), dtype=torch.int64, device="cuda")])
        return rows_fn(W, *a)

    G._masked_step, G._greedy_rows = counted_step, counted_rows
    try:
        yield log
    finally:
        G._masked_step, G._greedy_rows = step, rows_fn


def masked_step_counts(log):
    """The masked steps of a counted run: each half-step's, their total and
    the most in one half-step."""
    steps = [n for _, n, _ in log]
    return {"half_steps": len(steps), "masked_steps": sum(steps),
            "max_in_a_half_step": max(steps, default=0), "per_half_step": steps}


def greedycd_steps(X, W0, H0, iters=10):
    """Masked steps of every GreedyCD half-step over the first ``iters``
    iterations: the steps the half-step ran (its slowest row's count) and the
    mean over its rows.  The counting adds one device sum a step and no host
    read; it is switched on for this run only."""
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models import greedycd as G

    upd, _ = G.GreedyCD(maxiter=100)._resolved(torch.float32)
    Xr, w, h, _ = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda())
    with counted_masked_steps(active_sums=True) as log:
        common._solve_while_from(upd, (), Xr, w, h, 0, iters, 1e-30, with_objective=False)
    per_half = [{"rows": rows, "steps": steps, "mean_steps": float(tot) / rows}
                for rows, steps, tot in log]
    if len(per_half) != 2 * iters or not all(h["steps"] <= K * K for h in per_half):
        fail(f"greedycd_steps: {len(per_half)} half-steps logged for {iters} iterations")
    return {"iterations": iters, "half_steps": per_half,
            "max_steps": max(h["steps"] for h in per_half),
            "mean_steps_first_sweep": per_half[0]["mean_steps"],
            "mean_steps_last_sweep": per_half[-2]["mean_steps"]}


def time_iteration_parts_greedy(Xr, w, h):
    """Where one GreedyCD iteration goes, from the given factors: the two
    products, the Gram and score set-up, and the greedy loop, whose host
    reads (one a masked step) are counted; one masked step at full width on
    the device against the host time to enqueue it, and one host read."""
    from nmf_tpu_torch.models import greedycd as G
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.utils.dtypes import eps

    Xt = Xr.transpose()
    ht, wt = h.T.contiguous(), w.contiguous()
    parts = {
        "mm_fwd_ms": time_ms(lambda: matops.mm(Xr, ht), reps=3),
        "mm_bwd_ms": time_ms(lambda: matops.mm(Xt, wt), reps=3),
    }

    def setup(W, Ht, Z):
        P = Ht.T @ Ht
        Pdiag = torch.diagonal(P)
        denom = eps(torch.float32) + Pdiag
        G_ = W @ P - Z
        S, D = G._scores(W, G_, denom, Pdiag)
        return G_, S, D, P, denom, Pdiag, 0.001 * D.max().clamp_min(-1.0)

    step = G._masked_step
    count = [0]

    def counted(*a):
        count[0] += 1
        return step(*a)

    for name, X_, W_, Ht_ in (("W", Xr, wt, ht), ("H", Xt, ht, wt)):
        Z = matops.mm(X_, Ht_)
        parts[f"setup_{name}_ms"] = time_ms(lambda: setup(W_, Ht_, Z), reps=3)
        count[0] = 0
        G._masked_step = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G._halfstep(X_, W_, Ht_, 0.0)
            torch.cuda.synchronize()
            parts[f"halfstep_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            G._masked_step = step
        parts[f"masked_steps_{name}"] = parts[f"host_reads_{name}"] = count[0]
        parts[f"greedy_loop_{name}_ms"] = parts[f"halfstep_{name}_ms"] - (
            parts["mm_fwd_ms" if name == "W" else "mm_bwd_ms"] + parts[f"setup_{name}_ms"])
        # one masked step over all the rows: device time, and host time to
        # enqueue it with nothing read back
        G_, S, D, P, denom, Pdiag, thr = setup(W_, Ht_, Z)
        carry = G._Carry(torch.zeros_like(W_), G_, S, D, D.argmax(dim=1),
                         torch.zeros(W_.shape[0], dtype=torch.int32, device="cuda"))
        act = G._active(carry, thr, K * K)
        one = lambda: G._masked_step(W_, carry, act, P, denom, Pdiag)
        parts[f"masked_step_full_width_{name}_ms"] = time_ms(one, reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        parts[f"masked_step_enqueue_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        int(act.sum())
        parts[f"host_read_{name}_ms"] = (time.perf_counter() - t0) * 1e3
        del carry, G_, S, D, Z
    return parts


def time_iteration_parts(X, W0, H0):
    """Where one HALS iteration goes: the two products, the two 128-step
    column loops, the stop test and the objective, each timed on its own."""
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models.coorddesc import _halfstep
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.objectives import mse_objective

    Xr, w, h, _ = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    )
    Xt = Xr.transpose()
    ht = h.T.contiguous()
    wt = w.contiguous()
    parts = {
        "mm_fwd_ms": time_ms(lambda: matops.mm(Xr, ht), reps=3),
        "mm_bwd_ms": time_ms(lambda: matops.mm(Xt, wt), reps=3),
        "halfstep_W_ms": time_ms(lambda: _halfstep(Xr, w, h, 0.0, 0.0, range(K)), reps=3),
        "halfstep_H_ms": time_ms(lambda: _halfstep(Xt, h.T, w.T, 0.0, 0.0, range(K)), reps=3),
        "stop_condition_ms": time_ms(lambda: common.stop_condition(w, w, h, h, 1e-30), reps=3),
        "objective_ms": time_ms(lambda: mse_objective(Xr, w, h), reps=3),
    }
    parts["column_loop_W_ms"] = parts["halfstep_W_ms"] - parts["mm_fwd_ms"]
    parts["column_loop_H_ms"] = parts["halfstep_H_ms"] - parts["mm_bwd_ms"]
    # host time to enqueue one half-step (no synchronize after it): where it
    # is close to the device time above, the Python loop holds the card back
    for name, fn in (("W", lambda: _halfstep(Xr, w, h, 0.0, 0.0, range(K))),
                     ("H", lambda: _halfstep(Xt, h.T, w.T, 0.0, 0.0, range(K)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        parts[f"halfstep_{name}_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    return parts


def _monotone(label, start, history):
    """Exit when an objective of the traced run is not finite or rises by
    more than ``MONOTONE_TOL``, relative, from one iteration to the next."""
    if not all(math.isfinite(o) for o in history):
        fail(f"{label}: non-finite objective in {history}")
    for prev, cur in zip([start] + history[:-1], history):
        if cur > prev + MONOTONE_TOL * abs(prev):
            fail(f"{label}: objective rose {prev} -> {cur}")


def _traced_run(label, X, k, alg, W0, H0, iters, xsq, monotone=True, mesh=None):
    """``iters`` traced iterations of one solver through the front door (on
    ``mesh`` when one is given), with the launch counts of just this run;
    ``monotone`` holds its objective to ``_monotone`` (else the history is
    recorded and its values held finite)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.objectives import kl_objective, mse_objective

    objective = kl_objective if alg == "multdiv" else mse_objective
    Wt, Ht = (torch.as_tensor(a).cuda() for a in (W0, H0))
    start = float(objective(X, Wt, Ht))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = nt.nnmf(X, k, alg=alg, init="custom", W0=W0, H0=H0, tol=1e-30,
                  maxiter=iters, trace=True, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = build.launch_counts()
    hist = res.trace.objvalue.tolist()
    if not (res.niters == iters and tuple(res.W.shape) == tuple(W0.shape)
            and tuple(res.H.shape) == tuple(H0.shape)
            and bool(torch.isfinite(res.W).all()) and bool(torch.isfinite(res.H).all())
            and bool((res.W >= 0).all()) and bool((res.H >= 0).all())):
        fail(f"{label}: nnmf returned a bad result: {res}")
    if monotone:
        _monotone(label, start, hist)
    elif not all(math.isfinite(o) for o in hist):
        fail(f"{label}: non-finite objective in {hist}")
    if not abs(hist[-1] - res.objvalue) <= 1e-5 * abs(res.objvalue):
        fail(f"{label}: last traced objective differs from objvalue")
    relerr = math.sqrt(max(2.0 * float(mse_objective(X, res.W, res.H)), 0.0) / xsq)
    return {
        "iterations": iters, "seconds": seconds,
        "seconds_per_traced_iteration": seconds / iters,
        "start_objective": start, "objective_history": hist,
        "relerr_reached": relerr, "launches": launches,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
    }


def _need_launches(label, launches, names):
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        fail(f"{label}: kernels of this path never launched: {missing} in {launches}")


def _no_launches(label, launches, names):
    launched = [n for n in names if launches[n]]
    if launched:
        fail(f"{label}: kernels of another path launched: {launched} in {launches}")


def _seconds_per_iteration(X, upd, W0, H0, iters):
    """Seconds per iteration of the bare resumable loop (no objective reads)."""
    from nmf_tpu_torch.models import common

    W, H = (torch.as_tensor(a).cuda() for a in (W0, H0))
    if common._renumber_ok(upd, X):
        X, W, H, _ = common.renumbered_problem(X, W, H)
    state = common._prepare(upd, X, W, H)
    common._solve_while_from(upd, state, X, W, H, 0, 1, 1e-30, with_objective=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    common._solve_while_from(upd, state, X, W, H, 0, iters, 1e-30, with_objective=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def solve_mu_sparse(X, W0, H0, iters=20):
    """Sparse multiplicative updates on the full store, both objectives."""
    from nmf_tpu_torch.models.multupd import MultUpdate

    xsq = float(X.stats[1])
    out = {}
    for alg, obj, names in (
        ("multdiv", "div", ("chunk_matmul", "dense_matmul", "coo_matmul", "chunk_sddmm")),
        ("multmse", "mse", ("chunk_matmul", "dense_matmul", "coo_matmul")),
    ):
        r = _traced_run(f"solve_mu_sparse {alg}", X, K, alg, W0, H0, iters, xsq)
        _need_launches(f"solve_mu_sparse {alg}", r["launches"], names)
        r["seconds_per_iteration"] = _seconds_per_iteration(
            X, MultUpdate(obj=obj), W0, H0, 10)
        out[alg] = r
    return out


def solve_quad_store(Xq, W0, H0, hals_history):
    """The quad-tail store of the same matrix: Fast-HALS and GreedyCD for a
    few iterations each and the KL multiplicative updates for a few traced
    iterations, each through the front door with the launch counts of its own
    run.  The matrix is the one of the first path in another layout, so the
    traced HALS objectives must repeat that path's."""
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent
    from nmf_tpu_torch.models.greedycd import GreedyCD
    from nmf_tpu_torch.models.multupd import MultUpdate

    xsq = float(Xq.stats[1])
    products = ("chunk_matmul", "dense_matmul", "quad_matmul")
    out = {}
    for alg, upd, iters, names in (
        ("cd", CoordinateDescent(maxiter=100)._resolved(torch.float32)[0], 5, products),
        ("greedycd", GreedyCD(maxiter=100), 5, products),
        ("multdiv", MultUpdate(obj="div"), 5, products + ("chunk_sddmm", "quad_sddmm")),
    ):
        r = _traced_run(f"solve_quad_store {alg}", Xq, K, alg, W0, H0, iters, xsq)
        _need_launches(f"solve_quad_store {alg}", r["launches"], names)
        r["seconds_per_iteration"] = _seconds_per_iteration(Xq, upd, W0, H0, 5)
        out[alg] = r
    for a, b in zip(out["cd"]["objective_history"], hals_history):
        # the same sums in another order, fed through up to 5 sweeps
        if not abs(a - b) <= 1e-4 * abs(b):
            fail(f"solve_quad_store cd: objective {a} on the quad store, {b} on "
                 "the chunk store of the same matrix")
    return out


def _timed(parts, name, fn):
    """``fn()``, with its seconds (ending in a synchronize) under ``name``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    parts[name] = time.perf_counter() - t0
    return out


def nndsvd_in_parts(X):
    """``nndsvd(X, K, variant="ar")`` as ``nnmf`` calls it (seed 0), timed
    whole with the launch counts of its run, then step by step (the same
    calls from the same generators, a synchronize after each step); the
    randomized SVD's checks: the orthonormality of U, and
    ``||X - U S V'||^2 = ||X||^2 - sum(s^2)`` with both sides read."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.init import initialization as I
    from nmf_tpu_torch.ops import matops, tsqr
    from nmf_tpu_torch.ops.cuda import build

    xsq = float(X.stats[1])
    out = {}
    build.reset_launch_counts()
    W, H = _timed(out, "nndsvd_s", lambda: nt.nndsvd(
        X, K, variant="ar", generator=torch.Generator().manual_seed(0)))
    out["launches"] = build.launch_counts()
    parts = {}
    gsvd, gar = I.child_generators(torch.Generator().manual_seed(0), 2)
    p, n = X.shape
    l = K + 10
    omega = _timed(parts, "draw_s", lambda: torch.randn(
        (n, l), generator=gsvd, dtype=torch.float64).to("cuda", torch.float32))
    Y = _timed(parts, "sketch_s", lambda: matops.mm(X, omega))
    Q = _timed(parts, "first_qr_s", lambda: tsqr.cholesky_qr(Y))
    Xt = matops.transpose(X)

    def power(Q):
        for _ in range(2):
            Q = tsqr.cholesky_qr(matops.mm(X, tsqr.cholesky_qr(matops.mm(Xt, Q))))
        return Q

    Q = _timed(parts, "power_iterations_s", lambda: power(Q))
    one_qr = _timed(parts, "one_qr_s", lambda: tsqr.cholesky_qr(Y))  # for scale
    B = _timed(parts, "qtx_s", lambda: matops.mtm(Q.T, X))
    Ub, s, Vt = _timed(parts, "small_svd_s", lambda: torch.linalg.svd(B, full_matrices=False))
    U, s, V = _timed(parts, "rotate_s", lambda: ((Q @ Ub)[:, :K], s[:K], Vt[:K, :].T))

    def factors():
        r = torch.rand(K, generator=gar, dtype=torch.float32)
        Wb, Ht = I._nndsvd_factors(U, s, V, matops.mean(X), 2, True, r, torch.float32)
        return Wb, Ht.T.contiguous()

    W2, H2 = _timed(parts, "factor_build_s", factors)
    out["parts"] = parts
    out["parts_sum_s"] = sum(v for k_, v in parts.items() if k_ != "one_qr_s")
    # singular vectors of close singular values turn with any change in the
    # last bits, so the two starts are compared by what does not turn: their
    # singular values and their relative error
    s_whole = nt.rsvd(X, K, generator=I.child_generators(
        torch.Generator().manual_seed(0), 2)[0])[1]
    out["s_rel_diff_whole_vs_parts"] = float(((s_whole - s).abs() / s_whole).max())
    out["W_rel_diff_whole_vs_parts"] = float((W2 - W).norm() / W.norm())
    out["initial_relerr_parts"] = relerr_of(X, W2, H2, xsq)[1]
    out["svd_shape"] = [list(B.shape), l]
    eye = torch.eye(K, dtype=torch.float64, device="cuda")
    UtU = U.double().T @ U.double()
    VtV = V.double().T @ V.double()
    out["rsvd_U_orthonormality"] = float((UtU - eye).abs().max())
    sd = s.double()
    UtXV = matops.mtm(U.T.contiguous(), X).double() @ V.double()
    lhs = xsq - 2 * float((sd * torch.diagonal(UtXV)).sum()) + float(
        ((sd[:, None] * UtU * sd[None, :]) * VtV).sum())
    rhs = xsq - float((sd * sd).sum())
    out["rsvd_identity"] = {"residual_sq": lhs, "xsq_minus_sum_s_sq": rhs,
                            "rel_to_xsq": abs(lhs - rhs) / xsq}
    # the last CholeskyQR pass shifts a Gram close to I by l * eps * trace,
    # about l^2 eps: U is orthonormal to that in float32, and the identity
    # (which assumes it) holds to twice that of ||X||^2
    shift = l * l * float(torch.finfo(torch.float32).eps)
    out["qr_shift_of_last_pass"] = shift
    if not (out["rsvd_U_orthonormality"] <= 2 * shift
            and abs(lhs - rhs) <= 4 * shift * xsq):
        fail(f"rsvd checks: {out['rsvd_U_orthonormality']}, {out['rsvd_identity']}")
    out["singular_values_head"] = s[:8].tolist()
    if not (tuple(W.shape) == (p, K) and tuple(H.shape) == (K, n)
            and bool(torch.isfinite(W).all()) and bool(torch.isfinite(H).all())
            and bool((W >= 0).all()) and bool((H >= 0).all())):
        fail("nndsvd returned a bad start")
    out["initial_relerr"] = relerr_of(X, W, H, xsq)[1]
    if not (out["s_rel_diff_whole_vs_parts"] <= 1e-4
            and abs(out["initial_relerr"] - out["initial_relerr_parts"]) <= 1e-2):
        fail(f"nndsvd in parts differs from nndsvd: {out}")
    del Y, Q, B, omega, W2, H2, one_qr
    return out, W, H


def _result_ok(label, res, shape_w, shape_h):
    if not (tuple(res.W.shape) == shape_w and tuple(res.H.shape) == shape_h
            and bool(torch.isfinite(res.W).all()) and bool(torch.isfinite(res.H).all())
            and bool((res.W >= 0).all()) and bool((res.H >= 0).all())):
        fail(f"{label}: nnmf returned a bad result: {res}")


def solve_defaults(X, t_start):
    """The ``nnmf`` defaults on the store: the NNDSVD-ar start in its parts,
    GreedyCD from it through ``solve_main_path`` (to the target or 200
    iterations, the count reported and not limited), then the literal
    ``nnmf(X, K)`` with every default (``maxiter=60`` instead of 100 when the
    script has already run 600 s), each with the launch counts and the
    masked steps of its run."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.greedycd import GreedyCD
    from nmf_tpu_torch.ops.cuda import build

    xsq = float(X.stats[1])
    init, W, H = nndsvd_in_parts(X)
    W0, H0 = W.cpu().numpy(), H.cpu().numpy()
    del W, H
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with counted_masked_steps() as log:
        solved, _ = solve_main_path(X, W0, H0, "greedycd", GreedyCD(maxiter=100),
                                    max_iters=200, must_reach=False)
    solved["launches"] = build.launch_counts()
    solved["masked_steps"] = masked_step_counts(log)
    solved["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    _need_launches("solve_defaults greedycd", solved["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul", "projectnn"))
    capped = time.perf_counter() - t_start > 600
    kw = dict(maxiter=60) if capped else {}
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    lit = {}
    with counted_masked_steps() as log:
        res = _timed(lit, "seconds", lambda: nt.nnmf(X, K, **kw))
    lit["launches"] = build.launch_counts()
    lit["masked_steps"] = masked_step_counts(log)
    _result_ok("nnmf(X, 128)", res, (P, K), (K, N))
    _need_launches("nnmf(X, 128)", lit["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul", "projectnn"))
    lit.update(niters=res.niters, converged=res.converged, objvalue=res.objvalue,
               relerr=relerr_of(X, res.W, res.H, xsq)[1],
               maxiter=60 if capped else 100, capped_at_600_s=capped,
               seconds_per_iteration=lit["seconds"] / max(res.niters, 1),
               peak_device_memory_bytes=torch.cuda.max_memory_allocated())
    return {"init": init, "greedycd_from_nndsvdar": solved, "nnmf_defaults": lit}


def solve_random_replicates(X):
    """``nnmf(X, K, alg="cd", init="random", replicates=2, maxiter=5)``: two
    normalised random starts, so the column-sum and scaling kernels run."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    out = {}
    res = _timed(out, "seconds", lambda: nt.nnmf(
        X, K, alg="cd", init="random", replicates=2, maxiter=5))
    out["launches"] = build.launch_counts()
    _result_ok("replicates", res, (P, K), (K, N))
    _need_launches("replicates", out["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul", "colsum", "scale_cols"))
    out.update(niters=res.niters, objvalue=res.objvalue,
               relerr=relerr_of(X, res.W, res.H, float(X.stats[1]))[1])
    return out


def solve_defaults_dense(X):
    """``nnmf(X, DK, maxiter=20)`` with the default init and solver on the
    dense problem."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build

    xsq = float((X * X).sum(dtype=torch.float64))
    build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    res = _timed(out, "seconds", lambda: nt.nnmf(X, DK, maxiter=20))
    out["launches"] = build.launch_counts()
    _result_ok("nnmf(Xd, 64)", res, (DP, DK), (DK, DN))
    _need_launches("nnmf(Xd, 64)", out["launches"], ("projectnn", "dense_objective"))
    out.update(niters=res.niters, converged=res.converged, objvalue=res.objvalue,
               relerr=relerr_of(X, res.W, res.H, xsq)[1],
               peak_device_memory_bytes=torch.cuda.max_memory_allocated())
    return out


def time_to_target(label, X, upd, W0, H0, target, chunk, max_iters=5000):
    """Iterations and seconds of the resumable loop, in chunks of ``chunk``
    iterations with one relative-error read a chunk, until
    ``||X - W H|| / ||X|| <= target``; exits when the target is not reached."""
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.ops import matops

    W, H = (torch.as_tensor(a).cuda() for a in (W0, H0))
    xsq = float(matops.sq_norm(X))
    state = common._prepare(upd, X, W, H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 0
    _, r = relerr_of(X, W, H, xsq)
    while not r <= target and iters < max_iters:
        W, H, state, t, _, _ = common._solve_while_from(
            upd, state, X, W, H, 0, chunk, 1e-30, with_objective=False)
        iters += t
        _, r = relerr_of(X, W, H, xsq)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not r <= target:
        fail(f"{label}: relative error {r} after {iters} iterations, target {target}")
    return {"target": target, "iterations": iters, "seconds": seconds, "relerr": r}


@contextlib.contextmanager
def counted_pg_bodies():
    """Counts ALSPGrad's flat-loop bodies while the block runs: yields a list
    that gets one ``(bodies, pg_iterations)`` pair a half-step (inner
    solve)."""
    from nmf_tpu_torch.models import alspgrad

    log = []
    body, subsolve = alspgrad._flat_body, alspgrad._pg_subsolve
    count = [0]

    def counted_body(*a):
        count[0] += 1
        return body(*a)

    def counted_subsolve(*a, **kw):
        count[0] = 0
        Y, t = subsolve(*a, **kw)
        log.append((count[0], t))
        return Y, t

    alspgrad._flat_body, alspgrad._pg_subsolve = counted_body, counted_subsolve
    try:
        yield log
    finally:
        alspgrad._flat_body, alspgrad._pg_subsolve = body, subsolve


@contextlib.contextmanager
def counted_fnnls_levels():
    """Records FNNLS's cascade levels while the block runs: yields a list
    that gets one dict a buffer: its width (the columns active as it
    starts), its steps, their seconds on the host's clock (the last step
    ends in the host's read of the active count) and the columns still
    active after them."""
    from nmf_tpu_torch.ops import fnnls

    log = []
    run, step = fnnls._run, fnnls._masked_step
    count = [0]

    def counted_step(*a):
        count[0] += 1
        return step(*a)

    def counted_run(AtA, c, *a):
        count[0] = 0
        t0 = time.perf_counter()
        out = run(AtA, c, *a)
        log.append({"width": int(c.x.shape[0]), "steps": count[0],
                    "seconds": time.perf_counter() - t0, "active_after": out[2]})
        return out

    fnnls._run, fnnls._masked_step = counted_run, counted_step
    try:
        yield log
    finally:
        fnnls._run, fnnls._masked_step = run, step


def _bodies_summary(log):
    bodies = [b for b, _ in log]
    return {"half_steps": len(log), "bodies": sum(bodies),
            "bodies_per_half_step_mean": sum(bodies) / max(len(log), 1),
            "bodies_per_half_step_max": max(bodies, default=0),
            "pg_iterations_per_half_step_mean": sum(t for _, t in log) / max(len(log), 1)}


def solve_projals_alspgrad_dense(X, W0, H0):
    """ttt3 (``benchmarks/run.py:278-305``): ProjectedALS to relative error
    0.0125 within 300 iterations (chunks of 5) and ALSPGrad (``maxsubiter=20``)
    within 100 (chunks of 2) from the same start, each with the launches,
    peak memory and (ALSPGrad) flat-loop bodies of its run; 10 traced
    iterations of each through ``nnmf`` (ALSPGrad's objective held to
    ``MONOTONE_TOL``, ProjectedALS's, not monotone by nature, recorded);
    then ``nnmf(X, DK, alg=..., maxiter=20)`` with every
    other default, recording that ProjectedALS's NNDSVD-ar start hands it
    an H of zeros."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import alspgrad, interface
    from nmf_tpu_torch.models.projals import ProjectedALS
    from nmf_tpu_torch.ops.cuda import build

    xsq = float((X * X).sum(dtype=torch.float64))
    out = {}
    for alg, upd, chunk, max_iters, names in (
        ("projals", ProjectedALS(maxiter=100)._resolved(torch.float32)[0], 5, 300,
         ("projectnn", "dense_objective")),
        ("alspgrad", alspgrad.ALSPGrad(maxiter=100, maxsubiter=20)._resolved(
            torch.float32)[0], 2, 100, ("dense_objective",)),
    ):
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        with counted_pg_bodies() as log:
            r = time_to_target(f"ttt3 {alg}", X, upd, W0, H0, TTT3_TARGET, chunk,
                               max_iters)
        r["launches"] = build.launch_counts()
        _need_launches(f"ttt3 {alg}", r["launches"], names)
        r.update(seconds_per_iteration=r["seconds"] / max(r["iterations"], 1),
                 max_iterations=max_iters, chunk=chunk,
                 peak_device_memory_bytes=torch.cuda.max_memory_allocated())
        if log:
            r["pg_bodies"] = _bodies_summary(log)
        traced = _traced_run(f"ttt3 {alg} traced", X, DK, alg, W0, H0, 10, xsq,
                             monotone=alg == "alspgrad")
        out[alg] = {"to_target": r, "traced": traced}
    out["jax_records_iterations"] = {"projals": 285, "alspgrad": 38}

    nndsvd = interface.nndsvd
    for alg in ("projals", "alspgrad"):
        starts = []

        def recording_nndsvd(*a, **kw):
            W, H = nndsvd(*a, **kw)
            starts.append(int((H == 0).sum()))
            return W, H

        interface.nndsvd = recording_nndsvd
        build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        try:
            res = _timed(rec, "seconds", lambda: nt.nnmf(X, DK, alg=alg, maxiter=20))
        finally:
            interface.nndsvd = nndsvd
        rec["launches"] = build.launch_counts()
        _result_ok(f"nnmf(Xd, 64, alg={alg!r})", res, (DP, DK), (DK, DN))
        _need_launches(f"nnmf(Xd, 64, alg={alg!r})", rec["launches"],
                       ("projectnn", "dense_objective") if alg == "projals"
                       else ("dense_objective",))
        zeros = starts[0]
        if alg == "projals" and zeros != DK * DN:
            fail(f"nnmf projals: H of the start has {zeros} zeros of {DK * DN}")
        rec.update(niters=res.niters, converged=res.converged, objvalue=res.objvalue,
                   relerr=relerr_of(X, res.W, res.H, xsq)[1], start_H_zeros=zeros,
                   start_H_entries=DK * DN,
                   peak_device_memory_bytes=torch.cuda.max_memory_allocated())
        out[f"nnmf_{alg}"] = rec
    return out


def solve_projals_alspgrad_sparse(X, W0, H0, iters=10):
    """ProjectedALS and ALSPGrad (every default) for ``iters`` traced
    iterations each on the ttt4 chunk store through ``nnmf``: a finite
    objective (ALSPGrad's also held to ``MONOTONE_TOL``), the launches of
    each run, ALSPGrad's flat-loop bodies."""
    xsq = float(X.stats[1])
    products = ("chunk_matmul", "dense_matmul", "coo_matmul")
    out = {}
    for alg, names in (("projals", products + ("projectnn",)), ("alspgrad", products)):
        with counted_pg_bodies() as log:
            r = _traced_run(f"sparse {alg}", X, K, alg, W0, H0, iters, xsq,
                            monotone=alg == "alspgrad")
        _need_launches(f"sparse {alg}", r["launches"], names)
        if log:
            r["pg_bodies"] = _bodies_summary(log)
        out[alg] = r
    return out


def spa_store(X, rows, cols, vals):
    """spa4 (``benchmarks/run.py:656-700``): ``spa(X, 128)`` on the ttt4
    chunk store, whole (the launches of its run) and in its parts (anchors,
    W, the Grams, FNNLS by cascade level, the projection); the same bits
    both ways.  W's columns are X's anchor columns exactly (held against the
    host's COO arrays) and the anchors are distinct; FNNLS meets its KKT
    conditions in every column; on 4,096 columns the cascade gives the plain
    driver's bits; ``nnmf(X, 128, init="spa", alg="spa")`` gives the same
    anchors and bits; the relative error ``sqrt(2 mse) / ||X||``."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import spa as S
    from nmf_tpu_torch.ops import fnnls as F, matops
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.utils.numeric import projectnn

    xsq = float(X.stats[1])
    out = {}
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with counted_fnnls_levels() as levels:
        W, H = _timed(out, "seconds", lambda: nt.spa(X, K))
    out["launches"] = build.launch_counts()
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    _need_launches("spa", out["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul", "projectnn"))
    out["fnnls_levels"] = levels
    out["fnnls_cascade"] = dict(nt.config.fnnls_cascade)
    parts = {}
    ai = _timed(parts, "anchors_s", lambda: S._spa_anchors_sparse(X, K))
    Wp = _timed(parts, "W_s", lambda: S._store_columns(X, ai))
    AtA = _timed(parts, "AtA_s", lambda: Wp.double().T @ Wp.double())
    AtB = _timed(parts, "AtB_s", lambda: matops.mtm(Wp.T, X).double())
    with counted_fnnls_levels() as lv:
        x = _timed(parts, "fnnls_s", lambda: F.nnls_gram(AtA, AtB))
    Hp = _timed(parts, "project_s", lambda: projectnn(x.float()))
    out["parts"] = parts
    out["parts_fnnls_levels"] = lv
    if not (torch.equal(W, Wp) and torch.equal(H, Hp)):
        fail("spa: the whole call and its parts gave other bits")

    # W is X's anchor columns, exactly; the anchors are distinct
    anchors = ai.cpu().numpy()
    out["anchors_head"] = anchors[:8].tolist()
    if len(set(anchors.tolist())) != K:
        fail(f"spa: anchors repeat: {anchors.tolist()}")
    sel = np.isin(cols, anchors)
    slot = np.full(N, -1, np.int64)
    slot[anchors] = np.arange(K)
    want = np.zeros((P, K), np.float32)
    want[rows[sel], slot[cols[sel]]] = vals[sel]
    if not np.array_equal(W.cpu().numpy(), want):
        fail("spa: W's columns differ from X's anchor columns")
    out["anchor_column_nnz"] = int(sel.sum())

    # KKT: x >= 0; w = AtB - AtA x at most tol where x == 0, and on the
    # passive set within KKT_REL of the terms it is the difference of
    eps = torch.finfo(torch.float64).eps
    tol = 10 * eps * float(AtA.abs().sum(dim=0).max()) * K
    w = AtB - AtA @ x
    scale = AtA.abs() @ x.abs() + AtB.abs()
    passive = x > 0
    kkt = {"tol": tol, "min_x": float(x.min()),
           "max_w_inactive": float(torch.where(passive, -math.inf, w).max()),
           "max_w_passive_rel": float(torch.where(passive, w.abs() / scale, 0).max()),
           "passive_per_column_mean": float(passive.sum(0).double().mean()),
           "passive_per_column_max": int(passive.sum(0).max()),
           "rel_bound": KKT_REL}
    out["kkt"] = kkt
    if not (kkt["min_x"] >= 0 and kkt["max_w_inactive"] <= tol
            and kkt["max_w_passive_rel"] <= KKT_REL):
        fail(f"spa: FNNLS misses its KKT conditions: {kkt}")
    del w, scale, passive

    # the cascade against the plain driver on 4,096 columns
    sub = AtB[:, :4096].contiguous()
    cas = F.nnls_gram(AtA, sub, cascade=True)
    plain = F.nnls_gram(AtA, sub, cascade=False)
    if not torch.equal(cas, plain):
        fail("spa: FNNLS's cascade gave other bits than the plain driver")
    out["cascade_vs_plain_4096"] = {"same_bits": True,
                                    "same_bits_as_all_columns": torch.equal(plain, x[:, :4096])}
    del AtA, AtB, x, cas, plain, sub

    # through the front door
    seen = []
    anchors_of = S._spa_anchors_sparse

    def recording_anchors(*a):
        seen.append(anchors_of(*a))
        return seen[-1]

    S._spa_anchors_sparse = recording_anchors
    build.reset_launch_counts()
    rec = {}
    try:
        res = _timed(rec, "seconds", lambda: nt.nnmf(X, K, init="spa", alg="spa"))
    finally:
        S._spa_anchors_sparse = anchors_of
    rec["launches"] = build.launch_counts()
    if not (torch.equal(seen[0], ai) and torch.equal(res.W, W) and torch.equal(res.H, H)
            and res.niters == 0 and res.converged):
        fail(f"nnmf(X, 128, init='spa', alg='spa') differs from spa(X, 128): {res}")
    rec.update(objvalue=res.objvalue, same_anchors_and_bits=True)
    out["nnmf_spa"] = rec
    out["relerr"] = math.sqrt(max(2.0 * res.objvalue, 0.0) / xsq)
    out["H_nonzeros"] = int((H > 0).sum())
    return out


def solve_mu_dense(X, W0, H0, iters=10):
    """Dense multiplicative updates at full width, both objectives, and the
    two small problems to their targets."""
    from nmf_tpu_torch.models.multupd import MultUpdate
    from nmf_tpu_torch.ops.cuda import build

    xsq = float((X * X).sum(dtype=torch.float64))
    out = {}
    for alg, obj, names in (
        ("multdiv", "div", ("wtq", "qht", "dense_objective")),
        ("multmse", "mse", ("mu_factor_update", "dense_objective")),
    ):
        r = _traced_run(f"solve_mu_dense {alg}", X, DK, alg, W0, H0, iters, xsq)
        _need_launches(f"solve_mu_dense {alg}", r["launches"], names)
        r["seconds_per_iteration"] = _seconds_per_iteration(
            X, MultUpdate(obj=obj), W0, H0, 5)
        out[alg] = r

    for name, (p, n, k), obj, target, chunk, names in (
        ("ttt1", (500, 500, 8), "mse", 0.010, 200, ("mu_factor_update",)),
        ("ttt2", (2000, 1000, 32), "div", 0.020, 100, ("wtq", "qht")),
    ):
        rng = np.random.default_rng(0)
        Xs = torch.from_numpy(_lowrank_noisy(rng, p, n, k)).cuda()
        Ws = rng.random((p, k), dtype=np.float32)
        Hs = rng.random((k, n), dtype=np.float32)
        upd, _ = MultUpdate(obj=obj)._resolved(torch.float32)
        build.reset_launch_counts()
        r = time_to_target(name, Xs, upd, Ws, Hs, target, chunk)
        r["launches"] = build.launch_counts()
        _need_launches(name, r["launches"], names)
        r.update(shape=[p, n], k=k, obj=obj)
        out[name] = r
    return out


def time_iteration_parts_mu(X, W0, H0):
    """Where one sparse divergence iteration goes: its two sampled products
    (chunk kernel, dense sample, band, ``perm`` gather), the two value
    refreshes, the two sparse-dense products and the rest; host enqueue time
    of the whole sweep beside its device time."""
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models import multupd
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.objectives import kl_objective
    from nmf_tpu_torch.ops.sparse_format import TILE
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    Xr, w, h, _ = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda())
    side = Xr.fwd
    w32, ht = w.contiguous(), h.T.contiguous()
    n_chunk = side.coords.shape[0] * TILE
    n_dense = side.n_dblocks * TILE * TILE
    flat = torch.empty(n_chunk + n_dense + side.n_coo, device="cuda")
    perm = side.perm.long()
    delta = sqrt_eps(torch.float32)
    upd = multupd.MultUpdate(obj="div")
    wh = matops.sddmm(w, h, Xr)
    newvals = matops.nnz_values(Xr) / (wh + delta)
    Xq = matops.scale_values(Xr, newvals)
    parts = {
        "sddmm_chunk_kernel_ms": time_ms(lambda: S.chunk_sddmm(side, w32, ht, flat[:n_chunk]), reps=3),
        "sddmm_dense_sample_ms": time_ms(
            lambda: S.dense_sample(side, w32, ht, flat[n_chunk : n_chunk + n_dense]), reps=3),
        "sddmm_band_ms": time_ms(
            lambda: S.coo_sample(side, w32, ht, flat[n_chunk + n_dense :]), reps=3),
        "sddmm_perm_gather_ms": time_ms(lambda: flat[perm], reps=3),
        "sddmm_whole_ms": time_ms(lambda: matops.sddmm(w, h, Xr), reps=3),
        "quotient_values_ms": time_ms(lambda: matops.nnz_values(Xr) / (wh + delta), reps=3),
        "with_values_ms": time_ms(lambda: matops.scale_values(Xr, newvals), reps=3),
        "mtm_ms": time_ms(lambda: matops.mtm(w.T, Xq), reps=3),
        "mm_ms": time_ms(lambda: matops.mm(Xq, ht), reps=3),
        "iteration_ms": time_ms(lambda: multupd._update(upd, (), Xr, w, h), reps=3),
        "stop_condition_ms": time_ms(lambda: common.stop_condition(w, w, h, h, 1e-30), reps=3),
        "kl_objective_ms": time_ms(lambda: kl_objective(Xr, w, h), reps=3),
    }
    parts["rest_ms"] = parts["iteration_ms"] - (
        2 * (parts["sddmm_whole_ms"] + parts["quotient_values_ms"]
             + parts["with_values_ms"]) + parts["mtm_ms"] + parts["mm_ms"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multupd._update(upd, (), Xr, w, h)
    parts["iteration_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return parts


# ---------------------------------------------------------------------------
# a general sparse X, checkpointing, the Matrix Market loader


def _row_ptr(rows):
    """The CSR row pointer of row-sorted entries of a P-row matrix."""
    crow = np.zeros(P + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(rows, minlength=P))
    return crow


def general_csr(rows, cols, vals):
    """The ttt4 matrix as a ``torch.sparse_csr_tensor`` on the card and the
    port's container of it (``SparseCSR``), with the seconds the container
    took to build."""
    from nmf_tpu_torch.ops import matops

    crow = _row_ptr(rows)
    Xs = torch.sparse_csr_tensor(
        torch.from_numpy(crow).cuda(), torch.from_numpy(cols.astype(np.int64)).cuda(),
        torch.from_numpy(vals).cuda(), (P, N))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A = matops.as_operand(Xs)
    torch.cuda.synchronize()
    return Xs, A, time.perf_counter() - t0


# the general-CSR kernel's sweep: caps of a piece, column slabs at k = 128
CSR_CAPS = (256, 512, 1024, 2048)
CSR_SLABS = (128, 64, 32)


def _band_over_rows(side, D):
    """The general product before the general-CSR kernel: the band kernel
    (``coo_matmul``) over every row, ``crow`` as its row pointer, into
    zeros."""
    from nmf_tpu_torch.ops.cuda import build

    out = torch.zeros((side.rows, D.shape[1]), dtype=torch.float32, device=D.device)
    build.launch("coo_matmul", side.crow, side.col, side.val, D, out, side.rows,
                 D.shape[1])
    return out


def check_general_csr(A):
    """The general-CSR kernel (``csr_matmul``) over a whole general X, each
    orientation at k = 128: against its plain version run in float64 within
    ``REL_TOL``, the same bits twice, every row of at most
    ``CSR_PIECE_ENTRIES`` entries equal bit for bit to the band kernel over
    the rows (``_band_over_rows``), and timed (median of 9) beside
    ``torch.sparse.mm`` on a torch CSR tensor of the same arrays (median of
    9), the plain version and the band kernel over the rows.  The sweep:
    each cap of ``CSR_CAPS`` at each slab of ``CSR_SLABS``, the pairs read
    through the read-only path or evict-first; each result within
    ``REL_TOL``, and one cap's results the same bits at every slab and load.
    The bound: the row pointer, a column and a value an entry, the rows of D
    the entries read and the output, each once.  Then the sampled product
    over X (``csr_sample``, no kernel of its own) beside
    ``torch.sparse.sampled_addmm`` and its own bound."""
    import dataclasses

    from nmf_tpu_torch.ops.cuda import sparse as S
    from nmf_tpu_torch.ops.sparse_format import CSR_PIECE_ENTRIES, csr_piece_index

    gen = torch.Generator(device="cuda").manual_seed(12)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    rec = {"l2_bytes": l2, "cap": CSR_PIECE_ENTRIES}
    for sname, side in (("fwd", A.fwd), ("bwd", A.bwd)):
        D = torch.rand((side.cols, K), generator=gen, device="cuda")
        got = S.csr_matmul(side, D)
        torch.cuda.synchronize()
        want = S.csr_matmul_plain(side, D.double())
        r = _held(f"general csr csr_matmul {sname}", got, want, REL_TOL, (side.rows, K))
        r["same_bits"] = _same_bits(f"general csr csr_matmul {sname}",
                                    lambda: S.csr_matmul(side, D))
        band = _band_over_rows(side, D)
        lengths = side.crow.diff()
        short = lengths <= CSR_PIECE_ENTRIES
        if not torch.equal(got[short], band[short]):
            fail(f"general csr {sname}: a row of one piece differs from the band kernel's")
        r["band_rows_rel_err"] = _rel_err(band, want)[0] / r["scale"]
        lib_x = torch.sparse_csr_tensor(side.crow, side.col, side.val,
                                        (side.rows, side.cols))
        lerr = float((torch.sparse.mm(lib_x, D) - want).abs().max())
        if not lerr <= 1e-4 * r["scale"]:
            fail(f"general csr {sname}: yardstick disagrees ({lerr})")
        nnz = side.val.numel()
        d_rows = int(torch.unique(side.col).numel())
        nbytes = 4 * (side.rows + 1) + 8 * nnz + 4 * K * (d_rows + side.rows)
        bound_ms, by = bound_of(nbytes, 2 * nnz * K)
        r.update(ms=time_ms(lambda: S.csr_matmul(side, D), reps=9),
                 plain_ms=time_ms(lambda: S.csr_matmul_plain(side, D), reps=3),
                 library_ms=time_ms(lambda: torch.sparse.mm(lib_x, D), reps=9),
                 band_rows_ms=time_ms(lambda: _band_over_rows(side, D), reps=3),
                 bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=2 * nnz * K,
                 gathered_bytes=4 * K * nnz, operand_bytes=4 * K * side.cols,
                 stream_loads=S.CSR_STREAM_LOADS,
                 nnz=nnz, rows=side.rows, longest_row=int(lengths.max()),
                 rows_of_one_piece=int(short.sum()), pieces=side.piece_row.numel(),
                 split_rows=side.split_row.numel(), parts=side.n_parts)
        r["mnnz_per_s"] = nnz / r["ms"] / 1e3
        r["speedup_over_band_rows"] = r["band_rows_ms"] / r["ms"]
        sweep = {}
        for cap in CSR_CAPS:
            cut = dataclasses.replace(side, **csr_piece_index(side.crow, cap))
            first = None
            for slab in CSR_SLABS:
                for stream in (0, 1):
                    run = lambda: S.csr_launch(cut, D, slab, stream)  # noqa: E731
                    out = run()
                    torch.cuda.synchronize()
                    label = f"general csr {sname} cap={cap} slab={slab} stream={stream}"
                    if first is None:
                        first = out
                        _held(label, out, want, REL_TOL)
                    elif not torch.equal(out, first):
                        fail(f"{label}: other bits than the same cap's first run")
                    sweep[f"cap{cap}_slab{slab}_{'evict_first' if stream else 'ldg'}"] = \
                        time_ms(run)
                    del out
            del cut, first
        r["sweep_ms"] = sweep
        rec[sname] = r
        del got, want, lib_x, band
    # the sampled product over all of X: gather, gather, reduce in torch
    W = torch.rand((P, K), generator=gen, device="cuda")
    H = torch.rand((K, N), generator=gen, device="cuda")
    side = A.fwd
    got = S.csr_sample(side, W, H)
    pattern = torch.sparse_csr_tensor(side.crow, side.col, torch.zeros_like(side.val),
                                      (P, N))
    lib = torch.sparse.sampled_addmm(pattern, W, H, beta=0.0).values()
    want = S._sampled(side.row, side.col, W.double(), H.double().T.contiguous(),
                      torch.empty(side.val.numel(), dtype=torch.float64, device="cuda"))
    r = _held("general csr csr_sample", got, want, REL_TOL, (side.val.numel(),))
    if not float((lib - want).abs().max()) <= 1e-4 * r["scale"]:
        fail("general csr csr_sample: yardstick disagrees")
    nnz = side.val.numel()
    # the pattern (row pointer, columns), W and H once, a value an entry out
    nbytes = 4 * (P + 1) + 4 * nnz + 4 * K * (P + N) + 4 * nnz
    bound_ms, by = bound_of(nbytes, 2 * nnz * K)
    r.update(ms=time_ms(lambda: S.csr_sample(side, W, H), reps=3),
             library_ms=time_ms(lambda: torch.sparse.sampled_addmm(pattern, W, H, beta=0.0),
                                reps=3),
             bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=2 * nnz * K)
    rec["csr_sample"] = r
    return rec


def _hals_to_target(X, W0, H0, upd, max_iters=60, label="the general X"):
    """The resumable loop from ``(W0, H0)`` in chunks of 5, one relative-error
    read a chunk, to ``TARGET_RELERR``; exits when the target is missed."""
    from nmf_tpu_torch.models import common

    xsq = float(X.stats[1])
    w, h = (torch.from_numpy(a).cuda() for a in (W0, H0))
    state = common._prepare(upd, X, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters, r = 0, relerr_of(X, w, h, xsq)[1]
    while not r <= TARGET_RELERR and iters < max_iters:
        w, h, state, t, _, _ = common._solve_while_from(
            upd, state, X, w, h, 0, 5, 1e-30, with_objective=False)
        iters += t
        r = relerr_of(X, w, h, xsq)[1]
    torch.cuda.synchronize()
    if not r <= TARGET_RELERR:
        fail(f"HALS on {label}: relative error {r} after {iters} iterations")
    return {"iterations": iters, "seconds_to_target": time.perf_counter() - t0,
            "final_relerr": r}


def sparse_general(X, Xs, A, W0, H0, store_hals):
    """The ttt4 matrix as a torch CSR tensor on the card (``Xs``, held as
    ``A``) beside the chunk store ``X`` of the same matrix: the products at
    k = 128 against the store's, the same bits twice; HALS from the store
    phases' random start to the target; five sweeps of the KL updates and
    ``nnmf(Xs, 128, maxiter=5)`` with every other default, each against the
    store's run from the same start."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import build

    out = {"nnz": A.nnz, "container_bytes": sum(
        t.numel() * t.element_size() for side in (A.fwd, A.bwd)
        for t in (side.crow, side.row, side.col, side.val, side.src, side.piece_ptr,
                  side.piece_row, side.piece_part, side.split_ptr, side.split_row))}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for name, fn, rows in (("mm", lambda d: matops.mm(A, d), N),
                           ("mtm", lambda d: matops.mtm(d.T, A).T, P)):
        D = torch.rand((rows, K), generator=gen, device="cuda")
        want = (matops.mm(X, D) if name == "mm" else matops.mtm(D.T, X).T)
        out[name] = _held(f"sparse_general {name}", fn(D), want, REL_TOL)
        out[name]["same_bits"] = _same_bits(f"sparse_general {name}", lambda: fn(D))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    hals = _hals_to_target(A, W0, H0,
                           CoordinateDescent(maxiter=100)._resolved(torch.float32)[0])
    hals["launches"] = build.launch_counts()
    hals["store_iterations"] = store_hals["iterations"]
    hals["store_seconds_to_target"] = store_hals["seconds_to_target"]
    _need_launches("sparse_general hals", hals["launches"], ("csr_matmul",))
    _no_launches("sparse_general hals", hals["launches"], ("coo_matmul",))
    out["hals"] = hals
    runs = {}
    for tag, kw in (("multdiv", dict(alg="multdiv", init="custom", W0=W0, H0=H0,
                                     tol=1e-30, maxiter=5)),
                    ("nnmf_defaults", dict(maxiter=5))):
        build.reset_launch_counts()
        r = {}
        res = _timed(r, "seconds", lambda: nt.nnmf(Xs, K, **kw))
        r["launches"] = build.launch_counts()
        store = _timed(r, "store_seconds", lambda: nt.nnmf(X, K, **kw))
        _result_ok(f"sparse_general {tag}", res, (P, K), (K, N))
        if not res.W.is_cuda:
            fail(f"sparse_general {tag}: the result is not on the card")
        r.update(niters=res.niters, objvalue=res.objvalue,
                 store_objvalue=store.objvalue,
                 rel_diff=abs(res.objvalue - store.objvalue) / abs(store.objvalue))
        if not (math.isfinite(res.objvalue) and r["rel_diff"] <= 1e-4):
            fail(f"sparse_general {tag}: objective {res.objvalue} on the general X, "
                 f"{store.objvalue} on the store")
        _need_launches(f"sparse_general {tag}", r["launches"], ("csr_matmul",))
        _no_launches(f"sparse_general {tag}", r["launches"], ("coo_matmul",))
        runs[tag] = r
        del res, store
    out.update(runs)
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _equal_results(label, a, b):
    if not (torch.equal(a.W, b.W) and torch.equal(a.H, b.H) and a.niters == b.niters
            and a.converged == b.converged and a.objvalue == b.objvalue):
        fail(f"{label}: {a} against {b}")


def _checkpointed_against_plain(label, X, alg, W, H, every, tmp, cut=None):
    """``solve`` and ``solve_checkpointed`` from one start, timed, with the
    checkpointed run's launch counts; the same bits or the run fails.  With
    ``cut``, a run stopped at ``cut`` iterations and resumed must give them
    too."""
    import dataclasses

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build

    out = {}
    plain = _timed(out, "plain_seconds", lambda: nt.solve(alg, X, W, H))
    build.reset_launch_counts()
    ck = _timed(out, "checkpointed_seconds", lambda: nt.solve_checkpointed(
        alg, X, W, H, checkpoint_dir=f"{tmp}/{label}", checkpoint_every=every))
    out["launches"] = build.launch_counts()
    _equal_results(f"checkpoint {label}", ck, plain)
    out.update(niters=plain.niters, converged=plain.converged, objvalue=plain.objvalue,
               checkpoint_every=every, snapshots=-(-plain.niters // every),
               same_bits=True)
    if cut is not None:
        d = f"{tmp}/{label}_cut"
        nt.solve_checkpointed(dataclasses.replace(alg, maxiter=cut), X, W, H,
                              checkpoint_dir=d, checkpoint_every=every)
        resumed = _timed(out, "resumed_seconds", lambda: nt.solve_checkpointed(
            alg, X, W, H, checkpoint_dir=d, checkpoint_every=every))
        _equal_results(f"checkpoint {label} cut at {cut}", resumed, plain)
        out["cut_at"] = cut
    return out, plain


def checkpoint_store(X, W0, H0, tmp):
    """``solve_checkpointed`` on the chunk store: shuffled HALS (25
    iterations, a snapshot every 7) against ``solve``, also cut at 14 and
    resumed; GreedyCD (10, every 4) where two plain runs repeat bit for bit;
    a snapshot's bytes and the seconds of one save and one load of the ttt4
    factors."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import checkpoint as C

    W, H = (torch.from_numpy(a).cuda() for a in (W0, H0))
    out = {}
    hals = nt.CoordinateDescent(maxiter=25, shuffle=True,
                                generator=torch.Generator().manual_seed(21))
    out["hals"], res = _checkpointed_against_plain("hals", X, hals, W, H, 7, tmp, cut=14)
    _need_launches("checkpoint hals", out["hals"]["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul"))
    greedy = nt.GreedyCD(maxiter=10)
    a, b = nt.solve(greedy, X, W, H), nt.solve(greedy, X, W, H)
    repeats = bool(torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
                   and a.objvalue == b.objvalue)
    out["greedycd_plain_runs_repeat"] = repeats
    del a, b
    if repeats:
        out["greedycd"], _ = _checkpointed_against_plain("greedycd", X, greedy, W, H, 4, tmp)
        _need_launches("checkpoint greedycd", out["greedycd"]["launches"],
                       ("chunk_matmul", "dense_matmul", "coo_matmul", "projectnn"))
    # one snapshot of the ttt4 factors: its bytes, one save, one load
    tree = (res.W, res.H, (torch.Generator().manual_seed(1),),
            torch.tensor(25, dtype=torch.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = C.save_state(f"{tmp}/one", 25, tree)
    out["save_seconds"] = time.perf_counter() - t0
    out["snapshot_bytes"] = pathlib.Path(path).stat().st_size
    t0 = time.perf_counter()
    back = C.load_state(path, tree)
    torch.cuda.synchronize()
    out["load_seconds"] = time.perf_counter() - t0
    if not (torch.equal(back[0], res.W) and torch.equal(back[1], res.H)
            and back[0].is_cuda):
        fail("checkpoint: a saved snapshot did not load back to the same bits")
    return out


def checkpoint_dense(Xd, Wd0, Hd0, tmp):
    """ALSPGrad (its ``tolg`` the state) on ttt3, 12 iterations
    (``maxsubiter=20``, as the ttt3 cell), a snapshot every 5."""
    import nmf_tpu_torch as nt

    W, H = (torch.from_numpy(a).cuda() for a in (Wd0, Hd0))
    out, _ = _checkpointed_against_plain(
        "alspgrad_ttt3", Xd, nt.ALSPGrad(maxiter=12, maxsubiter=20), W, H, 5, tmp)
    _need_launches("checkpoint alspgrad", out["launches"], ("dense_objective",))
    return out


def _shard(rows, cols, vals, mesh, **opts):
    """``shard_tiled`` of the ttt4 matrix on ``mesh``, timed to the last
    block on the card."""
    from nmf_tpu_torch.ops.sparse_shard import shard_tiled

    t0 = time.perf_counter()
    X = shard_tiled(rows, cols, vals, (P, N), mesh, **opts)
    torch.cuda.synchronize()
    return X, time.perf_counter() - t0


def _layout(X, seconds):
    from nmf_tpu_torch.ops.sparse_shard import sharded_load_stats

    st = sharded_load_stats(X)
    return {"build_seconds": seconds, "block_nnz": X.block_nnz,
            "local_shape": list(X.local_shape),
            "imbalance_max_over_mean": st["imbalance_max_over_mean"],
            **{key: st[key].tolist() for key in st if key.endswith("_nnz")
               or key == "slots"}}


def _sharded_products(Xm, X, W0, H0, label):
    """The mesh's mm, mtm and sddmm at k = 128 against the store's, each
    within ``REL_TOL`` of ``max|want|``, the same bits twice and timed beside
    the store's (L2 flushed, median of 5)."""
    from nmf_tpu_torch.ops import matops

    gen = torch.Generator(device="cuda").manual_seed(17)
    W, H = torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    out = {}
    # the nnz vector's order is the blocks': both sides put in (row, col) order
    by_entry = [torch.argsort(matops.row_indices(A).long() * N
                              + matops.col_indices(A).long()) for A in (Xm, X)]
    calls = {"sddmm": (lambda A, _: matops.sddmm(W, H, A), None)}
    for name, fn, rows in (("mm", lambda A, d: matops.mm(A, d), N),
                           ("mtm", lambda A, d: matops.mtm(d.T, A).T, P)):
        calls[name] = (fn, torch.rand((rows, K), generator=gen, device="cuda"))
    for name in ("mm", "mtm", "sddmm"):
        fn, D = calls[name]
        got, want = fn(Xm, D), fn(X, D)
        if name == "sddmm":
            got, want = got[by_entry[0]], want[by_entry[1]]
        rec = _held(f"{label} {name}", got, want, REL_TOL)
        rec.update(same_bits=_same_bits(f"{label} {name}", lambda: fn(Xm, D)),
                   ms=time_ms(lambda: fn(Xm, D)), store_ms=time_ms(lambda: fn(X, D)))
        out[name] = rec
    return out


def sharded_phase(rows, cols, vals, X, W0, H0, store_hals, quad_paths, general_paths):
    """The multi-device path for a sparse X on one card: the ttt4 matrix
    cut into a 2 x 2 mesh of stores over ``cuda:0`` (and a (1, 1) one),
    built with the chunk store's options.  The (1, 1) mesh's products give
    the store's bits; the 2 x 2 mesh's products stay within ``REL_TOL`` of
    the store's and repeat bit for bit; HALS to the target, 10 GreedyCD
    iterations, 5 KL sweeps and ``nnmf(X, 128, mesh=...)`` with its other
    defaults run on the mesh, beside the store's runs from the same start; a
    quad-tail 2 x 2 mesh runs 5 HALS iterations and 5 KL sweeps.  With more
    than one card the same mesh shape over distinct cards gives the one-card
    mesh's bits."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import build

    opts = dict(dense_tile_nnz=192, coo_tail_nnz=3)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    one, secs = _shard(rows, cols, vals, nt.make_mesh((1, 1), devices=["cuda:0"]), **opts)
    out["mesh_1x1"] = _layout(one, secs)
    gen = torch.Generator(device="cuda").manual_seed(19)
    for name, fn, n_rows in (("mm", lambda A, d: matops.mm(A, d), N),
                             ("mtm", lambda A, d: matops.mtm(d.T, A).T, P)):
        D = torch.rand((n_rows, K), generator=gen, device="cuda")
        if not torch.equal(fn(one, D), fn(X, D)):
            fail(f"sharded: the (1, 1) mesh's {name} differs from the store's")
    out["mesh_1x1"]["store_bits"] = True
    del one

    mesh = nt.make_mesh((2, 2), devices=["cuda:0"] * 4)
    Xm, secs = _shard(rows, cols, vals, mesh, **opts)
    out["mesh_2x2"] = _layout(Xm, secs)
    out["products"] = _sharded_products(Xm, X, W0, H0, "sharded 2x2")
    xsq = float(Xm.stats[1])

    build.reset_launch_counts()
    hals = _hals_to_target(Xm, W0, H0,
                           CoordinateDescent(maxiter=100)._resolved(torch.float32)[0],
                           label="the 2 x 2 mesh")
    hals["launches"] = build.launch_counts()
    hals["store_iterations"] = store_hals["iterations"]
    hals["store_seconds_to_target"] = store_hals["seconds_to_target"]
    _need_launches("sharded hals", hals["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul"))
    out["hals"] = hals
    greedy = _traced_run("sharded greedycd", Xm, K, "greedycd", W0, H0, 10, xsq, mesh=mesh)
    _need_launches("sharded greedycd", greedy["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul"))
    out["greedycd"] = greedy
    div = _traced_run("sharded multdiv", Xm, K, "multdiv", W0, H0, 5, xsq, mesh=mesh)
    _need_launches("sharded multdiv", div["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul", "chunk_sddmm"))
    want = general_paths["multdiv"]["store_objvalue"]
    div.update(store_objvalue=want,
               rel_diff=abs(div["objective_history"][-1] - want) / abs(want))
    if not div["rel_diff"] <= 1e-4:
        fail(f"sharded multdiv: objective {div['objective_history'][-1]} on the "
             f"mesh, {want} on the store")
    out["multdiv"] = div
    build.reset_launch_counts()
    r = {}
    res = _timed(r, "seconds", lambda: nt.nnmf(Xm, K, maxiter=5, mesh=mesh))
    r["launches"] = build.launch_counts()
    _result_ok("sharded nnmf(X, 128, mesh=mesh)", res, (P, K), (K, N))
    want = general_paths["nnmf_defaults"]["store_objvalue"]
    r.update(niters=res.niters, objvalue=res.objvalue, store_objvalue=want,
             rel_diff=abs(res.objvalue - want) / abs(want))
    if not math.isfinite(res.objvalue):
        fail(f"sharded nnmf(X, 128, mesh=mesh): objective {res.objvalue}")
    _need_launches("sharded nnmf defaults", r["launches"],
                   ("chunk_matmul", "dense_matmul", "coo_matmul"))
    out["nnmf_defaults"] = r
    del res

    if torch.cuda.device_count() > 1:
        count = torch.cuda.device_count()
        multi = nt.make_mesh((2, 2), devices=[f"cuda:{i % count}" for i in range(4)])
        Xc, secs = _shard(rows, cols, vals, multi, **opts)
        rec = _layout(Xc, secs)
        rec["devices"] = [str(d) for d in multi.devices.reshape(-1)]
        for name, fn, n_rows in (("mm", lambda A, d: matops.mm(A, d), N),
                                 ("mtm", lambda A, d: matops.mtm(d.T, A).T, P)):
            D = torch.rand((n_rows, K), generator=gen, device="cuda")
            if not torch.equal(fn(Xc, D), fn(Xm, D)):
                fail(f"sharded: {name} over {count} cards differs from one card's")
            rec[f"{name}_ms"] = time_ms(lambda: fn(Xc, D))
        kw = dict(alg="cd", init="custom", W0=W0, H0=H0, tol=1e-30, maxiter=5)
        a = nt.nnmf(Xc, K, mesh=multi, **kw)
        b = nt.nnmf(Xm, K, mesh=mesh, **kw)
        _equal_results("sharded hals over several cards", a, b)
        rec["one_card_bits"] = True
        out["cards"] = rec
        del Xc, a, b
    # the multiprocess phase's reference: these runs on this one-process mesh
    out["multiprocess_reference"] = multiprocess_sparse_runs(Xm, mesh)
    del Xm
    torch.cuda.empty_cache()

    Xq, secs = _shard(rows, cols, vals, mesh, dense_tile_nnz=192, quad_tail_nnz=32)
    out["quad_mesh_2x2"] = _layout(Xq, secs)
    for alg, names in (("cd", ("chunk_matmul", "dense_matmul", "quad_matmul")),
                       ("multdiv", ("chunk_matmul", "dense_matmul", "quad_matmul",
                                    "chunk_sddmm", "quad_sddmm"))):
        rec = _traced_run(f"sharded quad {alg}", Xq, K, alg, W0, H0, 5, xsq, mesh=mesh)
        _need_launches(f"sharded quad {alg}", rec["launches"], names)
        for a, b in zip(rec["objective_history"], quad_paths[alg]["objective_history"]):
            if not abs(a - b) <= 1e-4 * abs(b):
                fail(f"sharded quad {alg}: objective {a} on the mesh, {b} on the "
                     "quad store")
        out[f"quad_{alg}"] = rec
    del Xq
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


@contextlib.contextmanager
def recorded_restarts():
    """Records, while the block runs, what each restart of ``nnmf`` gives:
    every ``solve`` of ``solve_replicates`` (the first solve, then the
    sequential loop's restarts), the lanes of ``solve_lanes`` (the batch),
    and the width of every product over a store.  Recording adds no work."""
    from nmf_tpu_torch.models import interface, replicates
    from nmf_tpu_torch.ops.cuda import sparse as S

    rec = {"solves": [], "lanes": [], "widths": []}
    saved = interface.solve, replicates.solve_lanes, S.tiled_mm, S.tiled_mtm

    def solve(*a, **kw):
        rec["solves"].append(saved[0](*a, **kw))
        return rec["solves"][-1]

    def lanes(*a, **kw):
        rec["lanes"].extend(saved[1](*a, **kw))
        return rec["lanes"]

    def widths(fn):
        return lambda X, D: (rec["widths"].append(D.shape[1]), fn(X, D))[1]

    interface.solve, replicates.solve_lanes = solve, lanes
    S.tiled_mm, S.tiled_mtm = widths(saved[2]), widths(saved[3])
    try:
        yield rec
    finally:
        interface.solve, replicates.solve_lanes, S.tiled_mm, S.tiled_mtm = saved


def restarts_each_way(label, X, k, kw, objective_tol, same_bits=False):
    """``nnmf(X, k, **kw)`` with its restarts one after the other, then as
    one batch (``parallel_replicates=True``): the seconds each way, the
    batched run's launches, product widths and peak memory, and each lane
    against its sequential restart: the same iteration count and flag, the
    objective within ``objective_tol`` (the same bits with ``same_bits``),
    and which solve won.  GreedyCD's masked steps (one host read each) are
    counted both ways."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build

    out = {}
    with recorded_restarts() as seq_rec, counted_masked_steps() as seq_steps:
        seq = _timed(out, "sequential_seconds", lambda: nt.nnmf(X, k, **kw))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    with recorded_restarts() as par_rec, counted_masked_steps() as par_steps:
        par = _timed(out, "batched_seconds",
                     lambda: nt.nnmf(X, k, parallel_replicates=True, **kw))
    out["launches"] = build.launch_counts()
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    _result_ok(label, par, tuple(seq.W.shape), tuple(seq.H.shape))
    first, restarts = seq_rec["solves"][0], seq_rec["solves"][1:]
    lanes = par_rec["lanes"]
    if not (len(par_rec["solves"]) == 1
            and len(lanes) == len(restarts) == kw["replicates"] - 1):
        fail(f"{label}: {len(par_rec['solves'])} solves and {len(lanes)} lanes in the "
             f"batched run, {len(restarts)} restarts in the sequential one")
    per_lane = []
    for i, ((W, H, niters, conv, objv), res) in enumerate(zip(lanes, restarts)):
        objv = float(objv)
        rec = {"niters": niters, "sequential_niters": res.niters, "converged": conv,
               "sequential_converged": res.converged, "objvalue": objv,
               "sequential_objvalue": res.objvalue,
               "rel_diff": abs(objv - res.objvalue) / abs(res.objvalue),
               "same_bits": torch.equal(W, res.W) and torch.equal(H, res.H)}
        if (niters, conv) != (res.niters, res.converged):
            fail(f"{label} lane {i}: {niters} iterations, converged {conv}; its "
                 f"sequential restart {res.niters}, {res.converged}")
        if not rec["rel_diff"] <= objective_tol or (same_bits and not rec["same_bits"]):
            fail(f"{label} lane {i}: objective {objv}, its sequential restart "
                 f"{res.objvalue} (same bits {rec['same_bits']})")
        per_lane.append(rec)
    def winner(res, objs):
        won = [i for i, o in enumerate(objs) if o == res.objvalue < first.objvalue]
        return f"restart {won[0]}" if won else "first solve"

    out.update(
        lanes=per_lane, first_objvalue=first.objvalue, objvalue=par.objvalue,
        sequential_objvalue=seq.objvalue,
        winner=winner(par, [r["objvalue"] for r in per_lane]),
        sequential_winner=winner(seq, [r.objvalue for r in restarts]),
        same_result_as_sequential=par == seq,
        product_widths=sorted(set(par_rec["widths"])))
    if seq_steps:  # GreedyCD: the first solve's half-steps come first both ways
        first_half_steps = 2 * first.niters
        # a batched half-step steps until its slowest row is done: its reads
        # should be the most any lane's restart took at that half-step
        at, by_restart = first_half_steps, []
        for res in restarts:
            by_restart.append([n for _, n, _ in seq_steps[at:at + 2 * res.niters]])
            at += 2 * res.niters
        out["host_reads"] = {
            "slowest_lane": sum(max(col) for col in itertools.zip_longest(
                *by_restart, fillvalue=0)),
            "sequential": sum(n for _, n, _ in seq_steps),
            "batched": sum(n for _, n, _ in par_steps),
            "sequential_restarts": sum(n for _, n, _ in seq_steps[first_half_steps:]),
            "batched_restarts": sum(n for _, n, _ in par_steps[first_half_steps:]),
            "first_solve": sum(n for _, n, _ in seq_steps[:first_half_steps])}
    return out


def wide_products(X, r=4, k=K):
    """One store product of width ``r * k`` against ``r`` of width ``k``:
    whether each column keeps its bits, and the times (L2 flushed, median
    of 5); the wide product also with its columns cut into narrower slabs
    than ``MAX_K`` (``wide_ms_by_slab``: a measurement, the package cuts at
    ``MAX_K``), and a product's time at other widths (``ms_by_width``)."""
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import sparse as S

    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    for name, fn, rows in (("mm", lambda d: matops.mm(X, d), N),
                           ("mtm", lambda d: matops.mtm(d.T, X).T, P)):
        D = torch.rand((rows, r * k), generator=gen, device="cuda")
        parts = [D[:, i * k:(i + 1) * k].contiguous() for i in range(r)]
        wide = fn(D)
        same = [torch.equal(wide[:, i * k:(i + 1) * k], fn(d)) for i, d in enumerate(parts)]
        rec = {"same_bits_by_lane": same, "width": r * k, "max_k": S.MAX_K,
               "wide_ms": time_ms(lambda: fn(D)),
               f"{r}_narrow_ms": time_ms(lambda: [fn(d) for d in parts]),
               "narrow_ms": time_ms(lambda: fn(parts[0])),
               "ms_by_width": {w: time_ms(lambda: fn(D[:, :w].contiguous()))
                               for w in (32, 64, 256, 384, S.MAX_K)},
               "wide_ms_by_slab": {}}
        rec["wide_over_narrow"] = rec["wide_ms"] / rec["narrow_ms"]
        try:
            for slab in (64, 128, 256):
                S.MAX_K = slab
                if not torch.equal(fn(D), wide):
                    fail(f"wide_products {name}: slabs of {slab} changed the bits")
                rec["wide_ms_by_slab"][slab] = time_ms(lambda: fn(D))
        finally:
            S.MAX_K = rec["max_k"]
        out[name] = rec
    return out


def lanes_iteration_parts(X, r=4):
    """Where a batched iteration goes, against ``r`` single-lane ones from
    the same normalised random starts, on the renumbered store: each
    half-step of Fast-HALS and GreedyCD as one batch and as ``r`` calls of
    the single-lane half-step, by events (L2 flushed, median of 3), and the
    host's time to enqueue the batched HALS half-steps (no synchronize
    after them)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.init.initialization import child_generators
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models import coorddesc as C
    from nmf_tpu_torch.models import greedycd as G

    starts = [nt.randinit(X, K, normalize=True, generator=g)
              for g in child_generators(torch.Generator().manual_seed(31), r)]
    Xr, Ws, Hs, _ = common.renumbered_problem(
        X, torch.stack([w for w, _ in starts]), torch.stack([h for _, h in starts]))
    Xt = Xr.transpose()
    Wt, Ht = Ws.transpose(1, 2), Hs.transpose(1, 2)
    halves = {
        "hals_W": (lambda: C._halfstep_lanes(Xr, Ws, Hs, 0.0, 0.0, range(K)),
                   lambda: [C._halfstep(Xr, Ws[i], Hs[i], 0.0, 0.0, range(K))
                            for i in range(r)]),
        "hals_H": (lambda: C._halfstep_lanes(Xt, Ht, Wt, 0.0, 0.0, range(K)),
                   lambda: [C._halfstep(Xt, Ht[i], Wt[i], 0.0, 0.0, range(K))
                            for i in range(r)]),
        "greedycd_W": (lambda: G._halfstep_lanes(Xr, Ws, Ht, 0.0),
                       lambda: [G._halfstep(Xr, Ws[i], Ht[i], 0.0) for i in range(r)]),
        "greedycd_H": (lambda: G._halfstep_lanes(Xt, Ht, Ws, 0.0),
                       lambda: [G._halfstep(Xt, Ht[i], Ws[i], 0.0) for i in range(r)]),
    }
    parts = {"lanes": r}
    for name, (batched, single) in halves.items():
        parts[f"{name}_batched_ms"] = time_ms(batched, reps=3)
        parts[f"{name}_{r}_single_ms"] = time_ms(single, reps=3)
        if name.startswith("hals"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched()
            parts[f"{name}_batched_enqueue_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        if name.endswith("_W"):
            parts[f"{name}_batched_device"] = device_profile(batched)
            parts[f"{name}_{r}_single_device"] = device_profile(single)
    return parts


def device_profile(fn, top=6):
    """One run of ``fn`` under ``torch.profiler``: the device's busy
    milliseconds (the kernels' own times summed) beside the wall time, and
    the kernels that took most of them.  "not measured" where the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the kernels' own rows (the operators' rows would count them again)
    own = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    own = sorted((r for r in own if r[1] > 0), key=lambda r: -r[1])
    if not own:
        return {"device_ms": "not measured", "wall_ms": wall}
    busy = sum(ms for _, ms, _ in own)
    return {"device_ms": busy, "wall_ms": wall, "idle_share": 1 - busy / wall,
            "top": [{"kernel": k[:80], "ms": ms, "count": n} for k, ms, n in own[:top]]}


def replicates_phase(X):
    """Batched restarts on the ttt4 chunk store at k 128: the wide products,
    HALS (5 replicates, 25 iterations), GreedyCD (4, 5) and the KL updates
    (3, 5), each run one restart after the other and as one batch; HALS and
    GreedyCD must run kernels 1, 2 and the band at the batch's width."""
    out = {"products": wide_products(X), "iteration_parts": lanes_iteration_parts(X)}
    for name, kw, tol, width, same in (
        ("hals", dict(alg="cd", init="random", replicates=5, maxiter=25), 1e-4, 4 * K, False),
        ("greedycd", dict(alg="greedycd", init="random", replicates=4, maxiter=5),
         1e-2, 3 * K, False),
        ("multdiv", dict(alg="multdiv", init="random", replicates=3, maxiter=5), 0.0,
         None, True),
    ):
        rec = restarts_each_way(f"replicates_batched {name}", X, K, kw, tol, same)
        if width is not None:
            if width not in rec["product_widths"]:
                fail(f"replicates_batched {name}: no product of width {width}: "
                     f"{rec['product_widths']}")
            _need_launches(f"replicates_batched {name}", rec["launches"],
                           ("chunk_matmul", "dense_matmul", "coo_matmul"))
        out[name] = rec
    return out


def sharded_dense_phase(Xd, Wd0, Hd0, mu_dense, dense_defaults):
    """The dense ttt3 problem on a 2 x 2 mesh over one card and on a (1, 1)
    one: the products, the divergence sweep's quotient products (kernels 8
    and 9 a block) and both objectives (kernel 6 a block) within
    ``REL_TOL`` of the whole X's, the same bits twice, timed beside the whole
    X's; the (1, 1) mesh's the whole X's bits; 10 KL and 10 MSE sweeps and 5
    HALS iterations on the mesh beside the whole X's; ``nnmf(Xd, 64,
    mesh=mesh, maxiter=20)`` against the whole X's objective; three
    restarts of the MSE updates as one batch on the mesh."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.objectives import kl_objective, mse_objective
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    torch.cuda.reset_peak_memory_stats()
    out = {}
    one = nt.shard_dense(Xd, nt.make_mesh((1, 1), devices=["cuda:0"]))
    mesh = nt.make_mesh((2, 2), devices=["cuda:0"] * 4)
    Xm = _timed(out, "cut_seconds", lambda: nt.shard_dense(Xd, mesh))
    out["block_shapes"] = [list(b.shape) for row in Xm.blocks for b in row]
    W, H = torch.from_numpy(Wd0).cuda(), torch.from_numpy(Hd0).cuda()
    gen = torch.Generator(device="cuda").manual_seed(29)
    D = torch.rand((DN, DK), generator=gen, device="cuda")
    D2 = torch.rand((DP, DK), generator=gen, device="cuda")
    delta = sqrt_eps(torch.float32)
    calls = {"mm": lambda A: matops.mm(A, D), "mtm": lambda A: matops.mtm(D2.T, A),
             "wtq": lambda A: matops.wtq(A, W, H, delta),
             "qht": lambda A: matops.qht(A, W, H, delta),
             "mse_objective": lambda A: mse_objective(A, W, H),
             "kl_objective": lambda A: kl_objective(A, W, H)}
    products = {}
    for name, fn in calls.items():
        want = fn(Xd)
        rec = _held(f"sharded_dense {name}", fn(Xm).reshape(-1), want.reshape(-1), REL_TOL)
        if not torch.equal(fn(one), want):
            fail(f"sharded_dense: the (1, 1) mesh's {name} differs from the whole X's")
        rec.update(same_bits=_same_bits(f"sharded_dense {name}", lambda: fn(Xm)),
                   one_by_one_bits=True, ms=time_ms(lambda: fn(Xm)),
                   whole_ms=time_ms(lambda: fn(Xd)))
        products[name] = rec
    out["products"] = products
    del one
    # kernels 8, 9 and 6 at a block's shape, against their plain versions
    b, wb, hb = Xm.blocks[0][0], W[:Xm.row_cuts[1]], H[:, :Xm.col_cuts[1]].contiguous()
    block = f"block {b.shape[0]}x{b.shape[1]} k={DK}"
    out["block_kernels"] = {**check_quotients(b, wb, hb, block, timed=True),
                            "dense_objective": check_objective(b, wb, hb, block, True)}

    xsq = float((Xd * Xd).sum(dtype=torch.float64))
    for alg, iters, names in (("multdiv", 10, ("wtq", "qht", "dense_objective")),
                              ("multmse", 10, ("mu_factor_update", "dense_objective")),
                              ("cd", 5, ("dense_objective",))):
        rec = _traced_run(f"sharded_dense {alg}", Xm, DK, alg, Wd0, Hd0, iters, xsq,
                          mesh=mesh)
        _need_launches(f"sharded_dense {alg}", rec["launches"], names)
        whole = (mu_dense[alg]["objective_history"] if alg in mu_dense else
                 _traced_run(f"dense {alg}", Xd, DK, alg, Wd0, Hd0, iters,
                             xsq)["objective_history"])
        rec["whole_objective_history"] = whole
        for a, w in zip(rec["objective_history"], whole):
            if not abs(a - w) <= 1e-4 * abs(w):
                fail(f"sharded_dense {alg}: objective {a} on the mesh, {w} on the whole X")
        out[alg] = rec
    build.reset_launch_counts()
    r = {}
    res = _timed(r, "seconds", lambda: nt.nnmf(Xd, DK, maxiter=20, mesh=mesh))
    r["launches"] = build.launch_counts()
    _result_ok("sharded_dense nnmf(Xd, 64, mesh=mesh)", res, (DP, DK), (DK, DN))
    want = dense_defaults["objvalue"]
    r.update(niters=res.niters, objvalue=res.objvalue, whole_objvalue=want,
             rel_diff=abs(res.objvalue - want) / abs(want))
    if not r["rel_diff"] <= 1e-2:
        fail(f"sharded_dense nnmf: objective {res.objvalue}, the whole X's {want}")
    _need_launches("sharded_dense nnmf defaults", r["launches"],
                   ("projectnn", "dense_objective"))
    out["nnmf_defaults"] = r
    del res
    rec = restarts_each_way(
        "sharded_dense replicates", Xm, DK,
        dict(alg="multmse", init="random", replicates=3, maxiter=8, mesh=mesh), 0.0,
        same_bits=True)
    _need_launches("sharded_dense replicates", rec["launches"],
                   ("mu_factor_update", "dense_objective", "colsum", "scale_cols"))
    out["replicates"] = rec
    out["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    # the multiprocess phase's reference: these runs on this one-process mesh
    out["multiprocess_reference"] = multiprocess_dense_runs(Xm, mesh)
    del Xm
    return out


def _digest(t):
    """A tensor's bits, as the first 16 hex digits of their sha256."""
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _digested_runs(runs):
    """Each of ``runs`` (name: call) once, timed to the card's end, its
    result's bits digested (a ``Result``: W, H, iterations, objective); the
    launch counts set to 0 before the first and read after the last."""
    from nmf_tpu_torch.ops.cuda import build

    out = {"digests": {}, "seconds": {}}
    build.reset_launch_counts()
    for name, fn in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["digests"][name] = (_digest(got) if isinstance(got, torch.Tensor) else
                                {"W": _digest(got.W), "H": _digest(got.H),
                                 "niters": got.niters, "objvalue": got.objvalue})
    out["launches"] = build.launch_counts()
    return out


def multiprocess_sparse_runs(Xm, mesh):
    """What the multiprocess phase runs on the ttt4 2 x 2 mesh, in one
    process or in each of several: ``mm`` / ``mtm`` on seeded operands, 5
    HALS iterations and 5 KL sweeps from a seeded start, ``nnmf(X, 128,
    mesh=mesh, maxiter=3)`` with its other defaults."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import matops

    dev = mesh.lead
    gen = torch.Generator(device=dev).manual_seed(MP_SEED)
    D = torch.rand((N, K), generator=gen, device=dev)
    D2 = torch.rand((P, K), generator=gen, device=dev)
    W0 = torch.rand((P, K), generator=gen, device=dev)
    H0 = torch.rand((K, N), generator=gen, device=dev)
    kw = dict(init="custom", W0=W0, H0=H0, maxiter=5, tol=1e-30, mesh=mesh, device=dev)
    return _digested_runs({
        "mm": lambda: matops.mm(Xm, D),
        "mtm": lambda: matops.mtm(D2.T, Xm),
        "hals": lambda: nt.nnmf(Xm, K, alg="cd", **kw),
        "multdiv": lambda: nt.nnmf(Xm, K, alg="multdiv", **kw),
        "nnmf_defaults": lambda: nt.nnmf(Xm, K, maxiter=3, mesh=mesh, device=dev),
    })


def multiprocess_dense_runs(Xm, mesh):
    """What the multiprocess phase runs on the ttt3 2 x 2 mesh of dense
    blocks: ``mm`` / ``mtm``, ``wtq`` / ``qht`` (kernels 8 and 9 a block),
    both objectives (kernel 6 a block) and 5 KL sweeps from a seeded start."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.objectives import kl_objective, mse_objective
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    dev = mesh.lead
    gen = torch.Generator(device=dev).manual_seed(MP_SEED + 1)
    D = torch.rand((DN, DK), generator=gen, device=dev)
    D2 = torch.rand((DP, DK), generator=gen, device=dev)
    W = torch.rand((DP, DK), generator=gen, device=dev)
    H = torch.rand((DK, DN), generator=gen, device=dev)
    delta = sqrt_eps(torch.float32)
    return _digested_runs({
        "mm": lambda: matops.mm(Xm, D),
        "mtm": lambda: matops.mtm(D2.T, Xm),
        "wtq": lambda: matops.wtq(Xm, W, H, delta),
        "qht": lambda: matops.qht(Xm, W, H, delta),
        "mse_objective": lambda: mse_objective(Xm, W, H),
        "kl_objective": lambda: kl_objective(Xm, W, H),
        "multdiv": lambda: nt.nnmf(Xm, DK, alg="multdiv", init="custom", W0=W, H0=H,
                                   maxiter=5, tol=1e-30, mesh=mesh, device=dev),
    })


def multiprocess_worker(argv):
    """One process of the multiprocess phase (``--rank R --world 2 --port
    PORT --data COO.npz --backend gloo|nccl --device cuda:I``): it joins the
    group, takes only its own entries of the ttt4 matrix and builds its
    blocks of the 2 x 2 mesh (``shard_tiled(..., local=True)``), runs
    ``multiprocess_sparse_runs``, then makes the ttt3 matrix on its card
    from the seed, keeps its blocks and runs ``multiprocess_dense_runs``.
    Its last line is one JSON object: its digests, launches and times."""
    import argparse

    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, required=True)
    for name in ("--data", "--backend", "--device"):
        ap.add_argument(name, required=True)
    a = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script only runs on the card")
    torch.cuda.set_device(a.device)
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.sparse_format import TILE
    from nmf_tpu_torch.ops.sparse_shard import sharded_load_stats
    from nmf_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"localhost:{a.port}", a.world, a.rank, backend=a.backend,
                     timeout=MP_TIMEOUT)
    build.load_kernels()
    mesh = nt.make_mesh((2, 2), devices=[a.device] * (4 // a.world))
    own = mesh.ranks == mesh.rank
    with np.load(a.data) as coo:
        rows, cols, vals = coo["rows"], coo["cols"], coo["vals"]
    local_p = -(-(-(-P // 2)) // TILE) * TILE
    local_n = -(-(-(-N // 2)) // TILE) * TILE
    mine = own[rows // local_p, cols // local_n]
    rec = {"rank": a.rank, "backend": a.backend, "device": a.device,
           "entries": int(mine.sum()), "setup_seconds": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    Xm = nt.shard_tiled(rows[mine], cols[mine], vals[mine], (P, N), mesh, local=True,
                        dense_tile_nnz=192, coo_tail_nnz=3)
    torch.cuda.synchronize()
    rec["build_seconds"] = time.perf_counter() - t0
    del rows, cols, vals
    slots = sharded_load_stats(Xm)["slots"]
    rec.update(slot_share=float(slots[own].sum() / slots.sum()), slots=slots.tolist(),
               block_nnz=Xm.block_nnz)
    rec["sparse"] = multiprocess_sparse_runs(Xm, mesh)
    del Xm
    torch.cuda.empty_cache()
    Xd = _lowrank_noisy_on_card(np.random.default_rng(0), DP, DN, DK)
    Xdm = nt.shard_dense(Xd, mesh)
    del Xd
    rec["dense"] = multiprocess_dense_runs(Xdm, mesh)
    rec["seconds"] = time.perf_counter() - t_start
    dist.destroy_process_group()
    print(json.dumps(rec), flush=True)
    return 0


def _run_ranks(data, backend, devices):
    """Two worker processes of this script, rank r on ``devices[r]``: each
    one's JSON line.  A worker that fails, or does not end within
    ``MP_TIMEOUT`` seconds, fails the run; every worker is ended."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--rank", str(r),
         "--world", str(len(devices)), "--port", str(port), "--data", str(data),
         "--backend", backend, "--device", dev],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r, dev in enumerate(devices)]
    deadline = time.monotonic() + MP_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        fail(f"multiprocess {backend}: a worker did not end within {MP_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            fail(f"multiprocess {backend} rank {r} exited {p.returncode}:\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def multiprocess_phase(data, sparse_ref, dense_ref):
    """One process a card: two processes of this script over gloo, both on
    ``cuda:0`` (NCCL refuses two ranks on one card, so every partial goes
    through the host), each building its own row of the ttt4 2 x 2 mesh
    from its own entries and keeping its own row of the ttt3 one.  Each
    rank must give the one-process 2 x 2 meshes' bits (``sparse_ref``,
    ``dense_ref``) everywhere, launch kernels 1, 2, 4 and the band (and 6, 8
    and 9 on the dense mesh) and hold at most 0.75 of the slots.  With two
    or more cards the same runs go once more over NCCL, rank r on
    ``cuda:r``."""
    layouts = [("gloo", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() > 1:
        layouts.append(("nccl", ["cuda:0", "cuda:1"]))
    out = {"one_process": {"sparse": sparse_ref, "dense": dense_ref}}
    for backend, devices in layouts:
        t0 = time.perf_counter()
        ranks = _run_ranks(data, backend, devices)
        for r, rec in enumerate(ranks):
            label = f"multiprocess {backend} rank {r}"
            for part, ref in (("sparse", sparse_ref), ("dense", dense_ref)):
                for name, want in ref["digests"].items():
                    got = rec[part]["digests"][name]
                    if got != want:
                        fail(f"{label}: {part} {name} gives {got}, the one-process "
                             f"mesh {want}")
            _need_launches(f"{label} sparse", rec["sparse"]["launches"],
                           ("chunk_matmul", "dense_matmul", "coo_matmul", "chunk_sddmm"))
            _need_launches(f"{label} dense", rec["dense"]["launches"],
                           ("dense_objective", "wtq", "qht"))
            if not rec["slot_share"] <= 0.75:
                fail(f"{label} holds {rec['slot_share']} of the slots")
        out[backend] = {"seconds": time.perf_counter() - t0, "devices": devices,
                        "one_process_bits": True, "ranks": ranks}
    return out



def loader_phase(rows, cols, vals, tmp):
    """The ttt4 matrix written as a Matrix Market file (``scipy.io.mmwrite``)
    and read back through the port's loader: ``load_mtx``, ``coo_to_csr``,
    ``to_bcoo`` onto the card, each timed; the entries must be the
    generator's; then ``nnmf(..., alg="cd", init="random", maxiter=5)`` on
    it, with the launch counts of its run."""
    import scipy.io
    import scipy.sparse

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import loader
    from nmf_tpu_torch.ops.cuda import build

    out = {}
    path = f"{tmp}/ttt4.mtx"
    m = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(P, N))
    _timed(out, "mmwrite_seconds", lambda: scipy.io.mmwrite(path, m, precision=9))
    out["file_bytes"] = pathlib.Path(path).stat().st_size
    coo = _timed(out, "load_mtx_seconds", lambda: loader.load_mtx(path))
    csr = _timed(out, "coo_to_csr_seconds", lambda: loader.coo_to_csr(coo))
    Xl = _timed(out, "to_bcoo_seconds", lambda: loader.to_bcoo(csr))
    crow = _row_ptr(rows)
    if not (np.array_equal(csr.indptr, crow) and np.array_equal(csr.indices, cols)
            and np.array_equal(csr.data, vals) and Xl.is_cuda
            and torch.equal(Xl.values().cpu(), torch.from_numpy(vals))):
        fail("loader: the entries read back are not the generator's")
    del coo, csr, m
    build.reset_launch_counts()
    res = _timed(out, "nnmf_seconds", lambda: nt.nnmf(
        Xl, K, alg="cd", init="random", maxiter=5))
    out["launches"] = build.launch_counts()
    _result_ok("loader nnmf", res, (P, K), (K, N))
    if not math.isfinite(res.objvalue):
        fail(f"loader nnmf: objective {res.objvalue}")
    _need_launches("loader nnmf", out["launches"], ("csr_matmul", "colsum"))
    _no_launches("loader nnmf", out["launches"], ("coo_matmul",))
    out.update(nnz=int(Xl.values().numel()), niters=res.niters, objvalue=res.objvalue)
    return out


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script only runs on the card")
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.sparse_format import build_tiled

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi, kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    # 2. build (kernel 11's two-pass design alongside, for its measurement)
    t0 = time.perf_counter()
    two_pass_build = start_two_pass_colsum_build()
    build.load_kernels()
    two_pass_colsum = load_two_pass_colsum(two_pass_build)
    logs = sorted(build.BUILD.glob("*.log"))
    ptxas = [ln.strip() for ln in logs[-1].read_text().splitlines()
             if "registers" in ln or "spill" in ln] if logs else []
    say("build", seconds=time.perf_counter() - t0,
        built_now=build.build_seconds is not None, ptxas=ptxas)

    # 3. kernels against their plain versions: small store, then full store
    rng = np.random.default_rng(3)
    rs, cs, vs = _movielens_like(rng, 3000, 2500, 400_000)
    Xs = build_tiled(rs, cs, vs, (3000, 2500), dense_tile_nnz=192, coo_tail_nnz=3)
    small = {f"k{k}": check_kernels(Xs, k, f"small store k={k}", timed=False)
             for k in (K, 9)}
    gen = torch.Generator(device="cuda").manual_seed(2)
    for k in (K, 9):
        Ws = torch.rand((3000, k), generator=gen, device="cuda")
        Hs = torch.rand((k, 2500), generator=gen, device="cuda")
        small[f"k{k}"]["chunk_sddmm"] = {
            "fwd": check_sddmm(Xs, Ws, Hs, f"small store k={k}", timed=False)}
    # the same small matrix as a quad-tail store (both sub-segment widths)
    # and with wide tail tiles (kernels 1 and 4 at span 4: a kernel check,
    # no path runs on such a store here)
    for tag, opts, classes, cls in (
        ("quad32", dict(dense_tile_nnz=192, quad_tail_nnz=32), ("chunk", "dense", "quad"), "quad"),
        ("quad16", dict(dense_tile_nnz=192, quad_tail_nnz=16, quad_seg=16), ("quad",), "quad"),
        ("span4", dict(dense_tile_nnz=192, tail_span=4, coo_tail_nnz=3), ("chunk",), "chunk"),
    ):
        Xv = build_tiled(rs, cs, vs, (3000, 2500), **opts)
        for k in (K, 9):
            rec = check_kernels(Xv, k, f"small {tag} store k={k}", timed=False,
                                classes=classes)
            Ws = torch.rand((3000, k), generator=gen, device="cuda")
            Hs = torch.rand((k, 2500), generator=gen, device="cuda")
            sd = check_sddmm(Xv, Ws, Hs, f"small {tag} store k={k}", timed=False, cls=cls)
            rec[f"{cls}_sddmm"] = {"fwd": sd, "tiled_sddmm": {"rel_err": sd["tiled_sddmm_rel_err"]}}
            small[f"{tag}_k{k}"] = rec
        del Xv
    say("kernels_sddmm_edges", tolerance=REL_TOL, same_bits=True,
        rel_err=check_sddmm_edges(rs, cs, vs, (3000, 2500)))
    say("kernels_small", shape=[3000, 2500], nnz=len(vs), tolerance=REL_TOL,
        rel_err={kk: {n: {s: r["rel_err"] for s, r in d.items()}
                      for n, d in v.items()} for kk, v in small.items()})
    del Xs, Ws, Hs

    # the dense kernels at a small ragged shape (edges in both directions,
    # a k that is no multiple of 4) before the full one
    rng = np.random.default_rng(4)
    Xe = torch.from_numpy(_lowrank_noisy(rng, 1000, 777, 5)).cuda()
    Xe[Xe < 0.5 * Xe.mean()] = 0.0  # exact zeros: the KL term's x = 0 branch
    edge = check_dense_kernels(
        Xe, torch.from_numpy(rng.random((1000, 5), dtype=np.float32)).cuda(),
        torch.from_numpy(rng.random((5, 777), dtype=np.float32)).cuda(),
        "ragged dense 1000x777 k=5", timed=False)
    say("kernels_dense_small", shape=[1000, 777], k=5,
        rel_err={n: (r["rel_err"] if "rel_err" in r
                     else {s: q["rel_err"] for s, q in r.items()})
                 for n, r in edge.items()})
    del Xe
    # kernels 8, 9 and 6 at ragged edges, unaligned rows and k across slabs
    say("kernels_dense_edges", tolerance=REL_TOL, same_bits=True,
        rel_err=check_quotient_edges())

    # kernels 10-12 at the shapes the paths give them (GreedyCD's W and H
    # half-steps and the normalised start at ttt4, the dense problem's W)
    # and at a ragged edge
    gen = torch.Generator(device="cuda").manual_seed(7)
    ew = {f"{m}x{n}": check_elementwise((m, n), timed=True, gen=gen)
          for m, n in ((P, K), (N, K), (DP, DK), (DN, DK), (1000, 777))}
    say("kernels_elementwise", card=smi, tolerance=EW_REL_TOL, **ew)
    # kernel 11 at its edges, from two streams, and against its two passes
    colsum_rec = check_colsum(two_pass_colsum, gen)
    say("kernels_colsum", card=smi, tolerance_ulps=1, **colsum_rec)
    # every k a kernel refused before it summed over k in slabs
    say("k_ceilings", tolerance=REL_TOL, shape=[3000, 2500],
        **check_k_ceilings(rs, cs, vs, (3000, 2500)))

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rows, cols, vals = _movielens_like(rng)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = build_tiled(rows, cols, vals, (P, N), dense_tile_nnz=192, coo_tail_nnz=3)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    W0 = rng.random((P, K), dtype=np.float32)
    H0 = rng.random((K, N), dtype=np.float32)
    # the quad-tail store of the same matrix
    t0 = time.perf_counter()
    Xq = build_tiled(rows, cols, vals, (P, N), dense_tile_nnz=192, quad_tail_nnz=32)
    torch.cuda.synchronize()
    t_build_quad = time.perf_counter() - t0

    def classes(side):
        c = {"chunks": int(side.panel_chunks.numel()),
             "chunks_stored": int(side.coords.shape[0]),
             "chunk_entries": int((side.vals != 0).sum()),
             "dense_blocks": int(side.dpanel_blocks.numel()),
             "dense_blocks_stored": side.n_dblocks,
             "band_entries": side.n_coo,
             "max_chunks_in_a_panel": int(side.panel_ptr.diff().max()),
             "max_blocks_in_a_panel": int(side.dpanel_ptr.diff().max())}
        if side.n_qchunks:
            c.update(quad_chunks_stored=side.n_qchunks,
                     quad_sub_segments=int(side.qpanel_segs.numel()),
                     quad_sub_segments_stored=int(side.q_rp.numel()),
                     quad_entries=int((side.qvals != 0).sum()),
                     max_sub_segments_in_a_panel=int(side.qpanel_ptr.diff().max()))
        return c

    say("store", shape=[P, N], nnz=len(vals), k=K, binner="numpy",
        data_seconds=t_data, host_build_seconds=t_build,
        host_build_seconds_quad=t_build_quad,
        **{s: classes(side) for s, side in (("fwd", X.fwd), ("bwd", X.bwd))},
        quad_store={s: classes(side) for s, side in (("fwd", Xq.fwd), ("bwd", Xq.bwd))})
    # the store's row and column sums in a fixed order
    say("sparse_sums", card=smi, tolerance=REL_TOL, **sparse_sums(X, rows, cols, vals))

    full = check_kernels(X, K, "full store", timed=True)
    say("kernels", tolerance=REL_TOL, card=smi, **full)
    sddmm = check_sddmm(X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda(),
                        "full store", timed=True)
    say("kernels_sddmm", card=smi, chunk_sddmm=sddmm)
    # kernels 3 and 5 on the quad-tail store
    quad = check_kernels(Xq, K, "quad store", timed=True, classes=("quad",))
    quad_sddmm = check_sddmm(Xq, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda(),
                             "quad store", timed=True, cls="quad")
    say("kernels_quad", tolerance=REL_TOL, card=smi, **quad, quad_sddmm=quad_sddmm)
    # kernels 1 and 3 with most panels split: the pass that adds partial
    # panels in piece order, on both stores
    say("kernels_split", tolerance=REL_TOL, card=smi,
        chunk_matmul=check_split(X, K, "full store", "chunk", 256, timed=True),
        dense_matmul=check_split(X, K, "full store", "dense", 2, timed=True),
        quad_matmul=check_split(Xq, K, "quad store", "quad", 64, timed=True))
    # no atomics: the products and five HALS iterations give the same bits
    say("same_bits_products", card=smi, **same_bits_products(X, W0, H0))
    # the general-CSR kernel over a whole general X: the matrix as a torch
    # CSR tensor on the card, held as the port's container
    Xs, A, t_container = general_csr(rows, cols, vals)
    general = check_general_csr(A)
    say("kernels_general_csr", tolerance=REL_TOL, card=smi,
        container_build_seconds=t_container, **general)

    # 4. the first path: sparse Fast-HALS
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent
    from nmf_tpu_torch.models.greedycd import GreedyCD

    say("small_problem", **small_problem_check())
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    solved, _ = solve_main_path(
        X, W0, H0, "cd", CoordinateDescent(maxiter=100)._resolved(torch.float32)[0],
        max_iters=60, must_reach=True)
    hals_launches = build.launch_counts()
    solved["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    solved["launches"] = hals_launches
    say("solve", target=TARGET_RELERR, card=smi, **solved)
    _need_launches("solve", hals_launches, ("chunk_matmul", "dense_matmul", "coo_matmul"))
    say("iteration_parts", card=smi, **time_iteration_parts(X, W0, H0))

    # 4b. GreedyCD, the default solver, on the same store: to the target or
    # 200 iterations (its count is chaotic near the flat end of its curve, so
    # it is reported and not limited)
    say("greedycd_steps", card=smi, **greedycd_steps(X, W0, H0))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    greedy, last = solve_main_path(X, W0, H0, "greedycd", GreedyCD(maxiter=100),
                                   max_iters=200, must_reach=False)
    greedy_launches = build.launch_counts()
    greedy["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    greedy["launches"] = greedy_launches
    say("solve_greedycd", target=TARGET_RELERR, card=smi, **greedy)
    _need_launches("solve_greedycd", greedy_launches,
                   ("chunk_matmul", "dense_matmul", "coo_matmul"))
    Xr, w0, h0, _ = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda())
    say("iteration_parts_greedycd", card=smi,
        first_iteration=time_iteration_parts_greedy(Xr, w0, h0),
        after_the_solve=time_iteration_parts_greedy(*last))
    del Xr, w0, h0, last

    # 4c. the quad-tail store: HALS, GreedyCD and the KL updates
    quad_paths = solve_quad_store(Xq, W0, H0, solved["nnmf_objective_history"])
    say("solve_quad_store", shape=[P, N], k=K, card=smi, **quad_paths)
    del Xq
    torch.cuda.empty_cache()

    # 4d. the nnmf defaults: NNDSVD-ar over the randomized SVD, GreedyCD from
    # it, the literal nnmf(X, 128); a normalised random start with a replicate
    defaults = solve_defaults(X, t_start)
    say("solve_defaults", target=TARGET_RELERR, card=smi, **defaults)
    replicates = solve_random_replicates(X)
    say("solve_random_replicates", card=smi, **replicates)
    torch.cuda.empty_cache()

    # 4e. the same matrix as a torch CSR tensor through every seam; snapshots
    # of solves on the store; the matrix through a Matrix Market file
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    t0 = time.perf_counter()
    general_paths = sparse_general(X, Xs, A, W0, H0, solved)
    say("sparse_general", shape=[P, N], k=K, card=smi,
        seconds=time.perf_counter() - t0, **general_paths)
    del Xs, A
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ckpt = checkpoint_store(X, W0, H0, tmp_dir.name)
    ckpt["store_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = loader_phase(rows, cols, vals, tmp_dir.name)
    say("loader", shape=[P, N], k=K, card=smi, seconds=time.perf_counter() - t0,
        **loaded)
    torch.cuda.empty_cache()
    # 4f. the multi-device path: the matrix cut into a 2 x 2 mesh of stores
    t0 = time.perf_counter()
    shards = sharded_phase(rows, cols, vals, X, W0, H0, solved, quad_paths,
                           general_paths)
    mp_sparse_ref = shards.pop("multiprocess_reference")
    say("sharded", shape=[P, N], k=K, card=smi, seconds=time.perf_counter() - t0,
        **shards)
    torch.cuda.empty_cache()
    # the matrix's entries for the multiprocess phase's workers (in 6)
    mp_data = pathlib.Path(tmp_dir.name) / "ttt4_coo.npz"
    np.savez(mp_data, rows=rows, cols=cols, vals=vals)
    # 4g. batched restarts on the store (the dense problem's part in 6)
    t0 = time.perf_counter()
    restarts = replicates_phase(X)
    say("replicates_batched", shape=[P, N], k=K, card=smi,
        seconds=time.perf_counter() - t0, **restarts)
    torch.cuda.empty_cache()

    # 5. the second path: multiplicative updates on the same store
    mu_sparse = solve_mu_sparse(X, W0, H0)
    say("solve_mu_sparse", shape=[P, N], k=K, card=smi, **mu_sparse)
    say("iteration_parts_mu", card=smi, **time_iteration_parts_mu(X, W0, H0))
    torch.cuda.empty_cache()

    # 5b. projected ALS and ALS projected gradient on the same store, then
    # SPA with its batched FNNLS (spa4)
    t0 = time.perf_counter()
    als_sparse = solve_projals_alspgrad_sparse(X, W0, H0)
    say("solve_projals_alspgrad_sparse", shape=[P, N], k=K, card=smi,
        seconds=time.perf_counter() - t0, **als_sparse)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spa4 = spa_store(X, rows, cols, vals)
    say("spa", shape=[P, N], k=K, nnz=len(vals), card=smi,
        phase_seconds=time.perf_counter() - t0, **spa4)
    del X, W0, H0, rows, cols
    torch.cuda.empty_cache()

    # 6. the third path: multiplicative updates on dense X
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    Xd = _lowrank_noisy_on_card(rng, DP, DN, DK)
    Wd0 = rng.random((DP, DK), dtype=np.float32)
    Hd0 = rng.random((DK, DN), dtype=np.float32)
    torch.cuda.synchronize()
    say("dense_problem", shape=[DP, DN], k=DK, bytes=Xd.numel() * 4,
        seconds=time.perf_counter() - t0)
    dense = check_dense_kernels(Xd, torch.from_numpy(Wd0).cuda(),
                                torch.from_numpy(Hd0).cuda(), "full dense", timed=True)
    say("kernels_dense", card=smi, shape=[DP, DN], k=DK, **dense)
    torch.cuda.empty_cache()
    # the dense kernels also at the small problems' shapes, where most of
    # their launches are: ttt1 runs kernel 7, ttt2 kernels 8 and 9 (their
    # objective, under 4M entries, is the plain expression, not kernel 6)
    small_paths = {}
    for name, (p, n, k) in (("ttt1", (500, 500, 8)), ("ttt2", (2000, 1000, 32))):
        rng = np.random.default_rng(0)
        Xt = torch.from_numpy(_lowrank_noisy(rng, p, n, k)).cuda()
        Wt = torch.from_numpy(rng.random((p, k), dtype=np.float32)).cuda()
        Ht = torch.from_numpy(rng.random((k, n), dtype=np.float32)).cuda()
        label = f"{name} {p}x{n} k={k}"
        # beside time_ms, each kernel's device time by graph_ms: what of a
        # row's time the kernel takes and what the host does around it
        if name == "ttt1":
            rec = {"mu_factor_update": check_factor_update(Xt, Wt, Ht, label, True,
                                                           graph=True)}
        else:
            rec = check_quotients(Xt, Wt, Ht, label, True, graph=True)
        small_paths[name] = rec
        say(f"kernels_dense_{name}", card=smi, shape=[p, n], k=k, **rec)
        del Xt, Wt, Ht
    mu_dense = solve_mu_dense(Xd, Wd0, Hd0)
    say("solve_mu_dense", shape=[DP, DN], k=DK, card=smi, **mu_dense)
    dense_defaults = solve_defaults_dense(Xd)
    say("solve_defaults_dense", shape=[DP, DN], k=DK, card=smi, **dense_defaults)
    # batched restarts on the dense problem: HALS, and ALS projected
    # gradient, whose lanes step one after the other (the sequential bits):
    # what a width-batched updater for it would have to save
    t0 = time.perf_counter()
    restarts["dense_hals"] = restarts_each_way(
        "replicates_batched dense hals", Xd, DK,
        dict(alg="cd", init="random", replicates=4, maxiter=10), 1e-4)
    restarts["dense_alspgrad"] = restarts_each_way(
        "replicates_batched dense alspgrad", Xd, DK,
        dict(alg="alspgrad", init="random", replicates=3, maxiter=2), 0.0,
        same_bits=True)
    say("replicates_batched_dense", shape=[DP, DN], k=DK, card=smi,
        seconds=time.perf_counter() - t0, dense_hals=restarts["dense_hals"],
        dense_alspgrad=restarts["dense_alspgrad"])
    # the dense problem cut into a 2 x 2 mesh of blocks over one card
    t0 = time.perf_counter()
    sharded_dense = sharded_dense_phase(Xd, Wd0, Hd0, mu_dense, dense_defaults)
    mp_dense_ref = sharded_dense.pop("multiprocess_reference")
    say("sharded_dense", shape=[DP, DN], k=DK, card=smi,
        seconds=time.perf_counter() - t0, **sharded_dense)
    torch.cuda.empty_cache()
    # one process a card: two processes over gloo on this card, each with
    # its own blocks of both meshes, against the one-process meshes' bits
    t0 = time.perf_counter()
    multiprocess = multiprocess_phase(mp_data, mp_sparse_ref, mp_dense_ref)
    say("multiprocess", card=smi, shape=[P, N], k=K, dense_shape=[DP, DN], dense_k=DK,
        seconds=time.perf_counter() - t0, **multiprocess)
    # ttt3: projected ALS and ALS projected gradient to relative error 0.0125
    t0 = time.perf_counter()
    als_dense = solve_projals_alspgrad_dense(Xd, Wd0, Hd0)
    say("solve_projals_alspgrad_dense", shape=[DP, DN], k=DK, card=smi,
        target=TTT3_TARGET, seconds=time.perf_counter() - t0, **als_dense)
    torch.cuda.empty_cache()
    # the snapshots' phase: the store's parts (4e) and ALSPGrad at ttt3
    t0 = time.perf_counter()
    ckpt["alspgrad_ttt3"] = checkpoint_dense(Xd, Wd0, Hd0, tmp_dir.name)
    ckpt["dense_seconds"] = time.perf_counter() - t0
    tmp_dir.cleanup()
    say("checkpoint", shape=[P, N], k=K, dense_shape=[DP, DN], dense_k=DK, card=smi,
        **ckpt)
    # the caller's TF32 setting neither reaches a solve nor is lost by one
    say("precision", shape=[DP, DN], k=DK, card=smi, **precision(Xd))
    del Xd

    # 7. the report: launches are those of the paths' runs, each read with
    # the counts set to 0 just before it
    paths = {
        "solve": hals_launches,
        "solve_greedycd": greedy_launches,
        "solve_quad_store_cd": quad_paths["cd"]["launches"],
        "solve_quad_store_greedycd": quad_paths["greedycd"]["launches"],
        "solve_quad_store_multdiv": quad_paths["multdiv"]["launches"],
        "solve_mu_sparse_multdiv": mu_sparse["multdiv"]["launches"],
        "solve_mu_sparse_multmse": mu_sparse["multmse"]["launches"],
        "solve_mu_dense_multdiv": mu_dense["multdiv"]["launches"],
        "solve_mu_dense_multmse": mu_dense["multmse"]["launches"],
        "ttt1": mu_dense["ttt1"]["launches"],
        "ttt2": mu_dense["ttt2"]["launches"],
        "nndsvd_init": defaults["init"]["launches"],
        "solve_defaults_greedycd": defaults["greedycd_from_nndsvdar"]["launches"],
        "nnmf_defaults": defaults["nnmf_defaults"]["launches"],
        "solve_random_replicates": replicates["launches"],
        "nnmf_defaults_dense": dense_defaults["launches"],
        "solve_projals_sparse": als_sparse["projals"]["launches"],
        "solve_alspgrad_sparse": als_sparse["alspgrad"]["launches"],
        "spa": spa4["launches"],
        "nnmf_spa": spa4["nnmf_spa"]["launches"],
        "ttt3_projals": als_dense["projals"]["to_target"]["launches"],
        "ttt3_alspgrad": als_dense["alspgrad"]["to_target"]["launches"],
        "ttt3_projals_traced": als_dense["projals"]["traced"]["launches"],
        "ttt3_alspgrad_traced": als_dense["alspgrad"]["traced"]["launches"],
        "nnmf_projals_dense": als_dense["nnmf_projals"]["launches"],
        "nnmf_alspgrad_dense": als_dense["nnmf_alspgrad"]["launches"],
        "sparse_general_hals": general_paths["hals"]["launches"],
        "sparse_general_multdiv": general_paths["multdiv"]["launches"],
        "sparse_general_nnmf_defaults": general_paths["nnmf_defaults"]["launches"],
        "checkpoint_hals": ckpt["hals"]["launches"],
        **({"checkpoint_greedycd": ckpt["greedycd"]["launches"]}
           if "greedycd" in ckpt else {}),
        "checkpoint_alspgrad_ttt3": ckpt["alspgrad_ttt3"]["launches"],
        "loader_nnmf": loaded["launches"],
        "sharded_hals": shards["hals"]["launches"],
        "sharded_greedycd": shards["greedycd"]["launches"],
        "sharded_multdiv": shards["multdiv"]["launches"],
        "sharded_nnmf_defaults": shards["nnmf_defaults"]["launches"],
        "sharded_quad_cd": shards["quad_cd"]["launches"],
        "sharded_quad_multdiv": shards["quad_multdiv"]["launches"],
        "replicates_batched_hals": restarts["hals"]["launches"],
        "replicates_batched_greedycd": restarts["greedycd"]["launches"],
        "replicates_batched_multdiv": restarts["multdiv"]["launches"],
        "replicates_batched_dense_hals": restarts["dense_hals"]["launches"],
        "replicates_batched_dense_alspgrad": restarts["dense_alspgrad"]["launches"],
        "sharded_dense_multdiv": sharded_dense["multdiv"]["launches"],
        "sharded_dense_multmse": sharded_dense["multmse"]["launches"],
        "sharded_dense_hals": sharded_dense["cd"]["launches"],
        "sharded_dense_nnmf_defaults": sharded_dense["nnmf_defaults"]["launches"],
        "sharded_dense_replicates": sharded_dense["replicates"]["launches"],
        # each worker of the multiprocess phase, read in that process
        **{f"multiprocess_{backend}_rank{r}_{part}": rec[part]["launches"]
           for backend in ("gloo", "nccl") if backend in multiprocess
           for r, rec in enumerate(multiprocess[backend]["ranks"])
           for part in ("sparse", "dense")},
    }
    # the paths on the dense problem (kernel 10 at its factors' shapes)
    # the dense X on the 2 x 2 mesh: kernels 6, 8 and 9 on its blocks
    block_paths = ["sharded_dense_multdiv", "sharded_dense_multmse",
                   "sharded_dense_hals", "sharded_dense_nnmf_defaults",
                   "sharded_dense_replicates",
                   *(q for q in paths if q.startswith("multiprocess_")
                     and q.endswith("_dense"))]
    dense_paths = ["nnmf_defaults_dense", "ttt3_projals", "ttt3_alspgrad",
                   "ttt3_projals_traced", "ttt3_alspgrad_traced",
                   "nnmf_projals_dense", "nnmf_alspgrad_dense",
                   "checkpoint_alspgrad_ttt3", "replicates_batched_dense_hals",
                   "replicates_batched_dense_alspgrad", *block_paths]
    csrc = "nmf_tpu_torch/csrc/"
    pallas = "nmf_tpu/ops/pallas/"
    # name: (source, TPU kernel, the records that make up one use of the kernel)
    meta = {
        "chunk_matmul": (csrc + "chunk_matmul.cu", pallas + "sparse.py:329", full["chunk_matmul"]),
        "dense_matmul": (csrc + "dense_matmul.cu", pallas + "sparse.py:624", full["dense_matmul"]),
        "quad_matmul": (csrc + "quad_matmul.cu", pallas + "sparse.py:537", quad["quad_matmul"]),
        # the band is no pallas_call in the reference: XLA's segment_sum
        "coo_matmul": (csrc + "coo_matmul.cu", pallas + "sparse.py:412", full["coo_matmul"]),
        # nor is the general product: XLA's bcoo_dot_general on a BCOO X
        "csr_matmul": (csrc + "csr_matmul.cu", "nmf_tpu/ops/matops.py:87",
                       {"fwd": general["fwd"], "bwd": general["bwd"]}),
        "chunk_sddmm": (csrc + "chunk_sddmm.cu", pallas + "sparse.py:738", {"fwd": sddmm}),
        "quad_sddmm": (csrc + "quad_sddmm.cu", pallas + "sparse.py:825", {"fwd": quad_sddmm}),
        "dense_objective": (csrc + "objectives.cu", pallas + "objectives.py:75", dense["dense_objective"]),
        "mu_factor_update": (csrc + "mu.cu", pallas + "mu.py:54", dense["mu_factor_update"]),
        "wtq": (csrc + "mu.cu", pallas + "mu.py:99", {"": dense["wtq"]}),
        "qht": (csrc + "mu.cu", pallas + "mu.py:143", {"": dense["qht"]}),
        "projectnn": (csrc + "elementwise.cu", pallas + "elementwise.py:37",
                      {"W": ew[f"{P}x{K}"]["projectnn"], "H": ew[f"{N}x{K}"]["projectnn"]}),
        "colsum": (csrc + "elementwise.cu", pallas + "elementwise.py:67",
                   {"": ew[f"{P}x{K}"]["colsum"]}),
        "scale_cols": (csrc + "elementwise.cu", pallas + "elementwise.py:74",
                       {"": ew[f"{P}x{K}"]["scale_cols"]}),
    }
    # where a kernel's launches come from shapes other than the one timed
    # above: each shape's times and its paths' launches beside the sums
    dense_shape = f"dense_{DP}x{DN}_k{DK}"
    not_in = lambda *names: [q for q in paths if q not in names]  # noqa: E731
    block_kernels = sharded_dense["block_kernels"]
    bp, bn = sharded_dense["block_shapes"][0]
    block_shape = f"dense_2x2_block_{bp}x{bn}_k{DK}"
    by_shape = {
        "mu_factor_update": {
            dense_shape: (dense["mu_factor_update"], not_in("ttt1")),
            "ttt1_500x500_k8": (small_paths["ttt1"]["mu_factor_update"], ["ttt1"]),
        },
        **{name: {
            dense_shape: ({"": dense[name]}, not_in("ttt2", *block_paths)),
            "ttt2_2000x1000_k32": ({"": small_paths["ttt2"][name]}, ["ttt2"]),
            block_shape: ({"": block_kernels[name]}, block_paths),
        } for name in ("wtq", "qht")},
        "dense_objective": {
            dense_shape: (dense["dense_objective"], not_in(*block_paths)),
            block_shape: (block_kernels["dense_objective"], block_paths),
        },
        # the normalised random starts: ttt4's W, and the dense problem's
        **{name: {
            f"ttt4_{P}x{K}": ({"": ew[f"{P}x{K}"][name]}, not_in(*dense_paths)),
            f"dense_{DP}x{DK}": ({"": ew[f"{DP}x{DK}"][name]}, dense_paths),
        } for name in ("colsum", "scale_cols")},
        "projectnn": {
            f"ttt4_{P}x{K}_{N}x{K}": ({"W": ew[f"{P}x{K}"]["projectnn"],
                                      "H": ew[f"{N}x{K}"]["projectnn"]},
                                     not_in(*dense_paths)),
            f"dense_{DP}x{DK}_{DN}x{DK}": ({"W": ew[f"{DP}x{DK}"]["projectnn"],
                                           "H": ew[f"{DN}x{DK}"]["projectnn"]},
                                          dense_paths),
        },
    }

    def per_use(parts):
        """Each use's own ms, plain, library and bound times (``fwd_ms``,
        ``fwd_plain_ms``, ...) beside the sums over the uses, and which uses
        those sums are over (``summed_over``)."""
        uses = [part for part in parts if part]
        return {**({"summed_over": uses} if len(uses) > 1 else {}),
                **{f"{part}_{key}": r[key] for part, r in parts.items() if part
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}}

    kernels = []
    for name, (source, replaces, parts) in meta.items():
        tot = lambda key: sum(r[key] for r in parts.values())
        by_path = {path: counts[name] for path, counts in paths.items() if counts[name]}
        if not by_path:
            fail(f"{name} was launched on no path")
        # a kernel with two uses a sweep (two orientations, two kinds) gives
        # the sums over both; each use stands beside them under its own name
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in parts.values()),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(parts.values(), key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": tot("library_ms"),
            "same_bits": all(r["same_bits"] for r in parts.values()),
            "launches_by_path": by_path,
            **per_use(parts),
            # kernel 2's bound on the CUDA cores beside its tensor-core one
            **({"bound_ms_cuda_core": tot("bound_ms_cuda_core")}
               if all("bound_ms_cuda_core" in r for r in parts.values()) else {}),
            **({"by_shape": {
                shape: {"launches": sum(by_path.get(q, 0) for q in qs),
                        "ms": sum(r["ms"] for r in recs.values()),
                        "bound_ms": sum(r["bound_ms"] for r in recs.values()),
                        "plain_ms": sum(r["plain_ms"] for r in recs.values()),
                        "library_ms": sum(r["library_ms"] for r in recs.values()),
                        **per_use(recs),
                        **({"graph_ms": sum(r["graph_ms"] for r in recs.values())}
                           if all("graph_ms" in r for r in recs.values()) else {})}
                for shape, (recs, qs) in by_shape[name].items()}}
               if name in by_shape else {}),
            # kernel 11: its device time alone and the two-pass design's
            **({key: colsum_rec["path_shape"][key] for key in (
                "graph_ms", "two_pass_ms", "two_pass_partial_ms", "two_pass_finish_ms",
                "two_pass_graph_ms")} if name == "colsum" else {}),
        })
    if sorted(k["name"] for k in kernels) != sorted(build.KERNELS):
        fail("the report does not list every kernel the build holds")
    floor = launch_floor()
    say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor["ms"],
                      "launch_floor_graph_ms": floor["graph_ms"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(multiprocess_worker(sys.argv[1:]) if "--rank" in sys.argv else main())
