#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA build: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card, ``nvcc`` and no network.  It builds the
thirteen CUDA kernels from ``nmf_tpu_torch/csrc/`` (the twelve that replace
the TPU kernels and the COO band's), holds each kernel against its plain
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
* multiplicative updates on a dense 100,000 x 10,000 low-rank problem at rank
  64, and on the two small dense problems (500 x 500 rank 8 to relative
  error 0.010, 2000 x 1000 rank 32 to 0.020); ``nnmf`` with its defaults on
  the dense problem.

Kernels 1, 2 and 3 are also run with most row panels cut into several
pieces (phase ``kernels_split``), and the products over the first store and
five HALS iterations on it give the same bits twice (phase
``same_bits_products``).  Every phase prints one JSON line; any failure
ends the run with a non-zero exit code.  There is no CPU path: without a
card the script fails at once.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
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
# the objective adds float32 terms into doubles: what is left is the float32
# rounding of each W @ H entry, which averages out over 1e9 terms
OBJECTIVE_TOL = 2e-6
MONOTONE_TOL = 1e-4  # an objective may rise by this much, relative, per step
# column sums added in double and rounded once; the scaling divides once
EW_REL_TOL = 1e-6
TARGET_RELERR = 0.84
P, N, K = 163_000, 59_000, 128
DP, DN, DK = 100_000, 10_000, 64  # the dense multiplicative-update problem


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


def _flush_l2():
    """Overwrite 256 MB so the next launch finds the 50 MB L2 cold, as a
    launch inside a HALS sweep does (the column loop streams the factor
    128 times between two products)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    _flush_buf.zero_()


def time_ms(fn, reps=5, warmup=1):
    """Median milliseconds of ``fn()`` by CUDA events, L2 flushed before
    each launch, a synchronize between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        _flush_l2()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


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
        # the function's own traffic: two coordinates in and one float out a
        # slot, the windows' and sub-segments' metadata, both factors
        meta_words = side.q_rp.numel() + side.qwin_panel.numel() + side.qwin_stripe.numel()
        slot_bytes = 3 * 4 * n_slots
    else:
        name, kern, plain = "chunk_sddmm", S.chunk_sddmm, S.chunk_sddmm_plain
        n_slots = side.coords.numel()
        meta_words = side.chunk_rp.numel() + side.win_panel.numel() + side.win_stripe.numel()
        slot_bytes = 2 * 4 * n_slots
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
        # the function's own traffic: coordinates in, one float a slot out,
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
            # read by this kernel on top of the floor: the refresh map, which
            # marks the padding slots
            extra_bytes=4 * n_slots,
        )
        r["mnnz_per_s"] = nnz / r["ms"] / 1e3
    return r


def check_dense_kernels(X, W, H, label, timed):
    """Kernels 6 (both kinds), 7 (both orientations), 8 and 9 against their
    plain versions run in float64 on the card."""
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.ops.cuda import objectives as O
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    p, n = X.shape
    k = W.shape[1]
    delta = sqrt_eps(torch.float32)
    lam = 0.01
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    rec = {}

    # 8, 9: the quotient products
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
            # the walk cut into other numbers of runs than the wrapper's rule
            # picks (the evidence for that rule's blocks-a-multiprocessor)
            rule = M.walk_splits
            r["runs"] = rule(shape[1] if name == "wtq" else shape[0],
                             p if name == "wtq" else n, k, X.device)
            r["ms_by_runs"] = {}
            try:
                for runs in (1, 2, 4, 7, 14, 28, 56):
                    M.walk_splits = lambda *a, runs=runs: runs
                    r["ms_by_runs"][runs] = time_ms(lambda: fn(X, W, H, delta), reps=3)
            finally:
                M.walk_splits = rule
        rec[name] = r
        del got

    # 6: the objectives
    rec["dense_objective"] = {}
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
        rec["dense_objective"][kind] = r
    del Xd

    # 7: the factor update, as the H step and as the W step call it
    rec["mu_factor_update"] = {}
    G_h, C_h = W.T @ W, W.T @ X
    G_w, C_w = H @ H.T, X @ H.T
    for side, F, G, C in (("H", H, G_h, C_h), ("W", W.T, G_w, C_w.T)):
        got = M.mu_factor_update(F, G, C, lam, delta)
        torch.cuda.synchronize()
        want = M.mu_factor_update_plain(F.double(), G.double(), C.double(), lam, delta)
        r = _held(f"{label} mu_factor_update {side}", got, want, REL_TOL, F.shape)
        if got.stride() != F.stride():
            fail(f"{label} mu_factor_update {side}: result layout differs from F's")
        r["same_bits"] = _same_bits(f"{label} mu_factor_update {side}",
                                    lambda: M.mu_factor_update(F, G, C, lam, delta))
        if timed:
            m = F.shape[1]
            bound_ms, by = bound_of(4 * (3 * k * m + k * k), 2 * k * k * m + 4 * k * m)
            r.update(ms=time_ms(lambda: M.mu_factor_update(F, G, C, lam, delta)),
                     plain_ms=time_ms(lambda: M.mu_factor_update_plain(F, G, C, lam, delta)),
                     bound_ms=bound_ms, bound_by=by)
            r["library_ms"] = r["plain_ms"]  # the plain expression
        rec["mu_factor_update"][side] = r
    return rec


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
            r[f"mu_factor_update_{side}"] = _held(
                f"k_ceilings mu_factor_update {side} k={k}", got, want, REL_TOL)["rel_err"]
        for kind, fn in (("mse", O.mse_objective_kernel), ("kl", O.kl_objective_kernel)):
            r[f"objective_{kind}"] = _held(
                f"k_ceilings objective {kind} k={k}", fn(X, W, H).reshape(1),
                O.dense_objective_plain(Xd, Wd, Hd, kind).reshape(1), REL_TOL)["rel_err"]
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
        log.append([W.shape[0], 0, torch.zeros((), dtype=torch.int64, device="cuda")])
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


def _traced_run(label, X, k, alg, W0, H0, iters, xsq):
    """``iters`` traced iterations of one solver through the front door, with
    the launch counts of just this run."""
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
                  maxiter=iters, trace=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = build.launch_counts()
    hist = res.trace.objvalue.tolist()
    if not (res.niters == iters and tuple(res.W.shape) == tuple(W0.shape)
            and tuple(res.H.shape) == tuple(H0.shape)
            and bool(torch.isfinite(res.W).all()) and bool(torch.isfinite(res.H).all())
            and bool((res.W >= 0).all()) and bool((res.H >= 0).all())):
        fail(f"{label}: nnmf returned a bad result: {res}")
    _monotone(label, start, hist)
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


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script only runs on the card")
    import nmf_tpu_torch  # noqa: F401  (TF32 off)
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.sparse_format import build_tiled

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", nvidia_smi=smi, kind=kind, torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # 2. build
    t0 = time.perf_counter()
    build.load_kernels()
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

    # kernels 10-12 at the shapes the paths give them (GreedyCD's W and H
    # half-steps and the normalised start at ttt4, the dense problem's W)
    # and at a ragged edge
    gen = torch.Generator(device="cuda").manual_seed(7)
    ew = {f"{m}x{n}": check_elementwise((m, n), timed=True, gen=gen)
          for m, n in ((P, K), (N, K), (DP, DK), (1000, 777))}
    say("kernels_elementwise", card=smi, tolerance=EW_REL_TOL, **ew)
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
    del rows, cols

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

    # 5. the second path: multiplicative updates on the same store
    mu_sparse = solve_mu_sparse(X, W0, H0)
    say("solve_mu_sparse", shape=[P, N], k=K, card=smi, **mu_sparse)
    say("iteration_parts_mu", card=smi, **time_iteration_parts_mu(X, W0, H0))
    del X, W0, H0
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
    mu_dense = solve_mu_dense(Xd, Wd0, Hd0)
    say("solve_mu_dense", shape=[DP, DN], k=DK, card=smi, **mu_dense)
    dense_defaults = solve_defaults_dense(Xd)
    say("solve_defaults_dense", shape=[DP, DN], k=DK, card=smi, **dense_defaults)
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
    }
    csrc = "nmf_tpu_torch/csrc/"
    pallas = "nmf_tpu/ops/pallas/"
    # name: (source, TPU kernel, the records that make up one use of the kernel)
    meta = {
        "chunk_matmul": (csrc + "chunk_matmul.cu", pallas + "sparse.py:329", full["chunk_matmul"]),
        "dense_matmul": (csrc + "dense_matmul.cu", pallas + "sparse.py:624", full["dense_matmul"]),
        "quad_matmul": (csrc + "quad_matmul.cu", pallas + "sparse.py:537", quad["quad_matmul"]),
        # the band is no pallas_call in the reference: XLA's segment_sum
        "coo_matmul": (csrc + "coo_matmul.cu", pallas + "sparse.py:412", full["coo_matmul"]),
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
            **{f"{part}_ms": r["ms"] for part, r in parts.items() if part},
            # kernel 2's bound on the CUDA cores beside its tensor-core one
            **({"bound_ms_cuda_core": tot("bound_ms_cuda_core")}
               if all("bound_ms_cuda_core" in r for r in parts.values()) else {}),
        })
    if sorted(k["name"] for k in kernels) != sorted(build.KERNELS):
        fail("the report does not list every kernel the build holds")
    say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
