#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA build: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card, ``nvcc`` and no network.  It builds the CUDA
kernels from ``nmf_tpu_torch/csrc/``, holds each kernel against its plain
PyTorch version on the card, and drives the main path — sparse Fast-HALS on
the 163,000 x 59,000 power-law problem (about 17.6M nonzeros, rank 128) —
through ``nnmf`` and the resumable solver loop down to relative error 0.84.

Every phase prints one JSON line; any failure ends the run with a non-zero
exit code.  There is no CPU path: without a card the script fails at once.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
FP32_FLOPS = 67e12  # CUDA cores; both kernels are exact fp32

REL_TOL = 2e-5  # kernel vs plain version: f32 sums taken in another order
TARGET_RELERR = 0.84
P, N, K = 163_000, 59_000, 128


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
        cols = side.win_panel[win].long()[:, None] * TILE + (co >> 7)
        vals = side.vals[ids]
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
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
    needs at the fp32 CUDA-core peak."""
    from nmf_tpu_torch.ops.sparse_format import TILE

    d_and_out = 4 * k * (side.cols + side.rows)
    if cls == "chunk":
        n_items = side.panel_chunks.numel()
        nbytes = (n_items * (TILE * 8 + 4) + 4 * side.panel_ptr.numel()
                  + 4 * side.win_panel.numel() + d_and_out)
        flops = 2 * nnz * k
    else:
        n_items = side.dpanel_blocks.numel()
        # the dense kernel adds into its output: read once and written once
        nbytes = (n_items * (TILE * TILE * 4 + 4) + 4 * side.dpanel_ptr.numel()
                  + 4 * side.dblk_panel.numel() + d_and_out + 4 * k * side.rows)
        flops = 2 * TILE * TILE * k * n_items
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, flops, n_items


def check_kernels(X, k, label, timed):
    """Each kernel against its plain version, both orientations.  Returns
    ``{kernel: {side: record}}``; exits when a result disagrees."""
    from nmf_tpu_torch.ops.cuda import sparse as S

    gen = torch.Generator(device="cuda").manual_seed(1)
    rec = {"chunk_matmul": {}, "dense_matmul": {}}
    for sname, side in (("fwd", X.fwd), ("bwd", X.bwd)):
        D = torch.rand((side.cols, k), generator=gen, device="cuda")
        for name, cls, kern, plain in (
            ("chunk_matmul", "chunk", S.chunk_matmul, S.chunk_matmul_plain),
            ("dense_matmul", "dense", S.dense_matmul, S.dense_matmul_plain),
        ):
            if cls == "dense" and not side.n_dblocks:
                fail(f"{label}: the {sname} side has no dense block to check")
            got = kern(side, D)
            torch.cuda.synchronize()
            want = plain(side, D)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            r = {"max_abs_err": err, "rel_err": err / scale, "scale": scale}
            if not (tuple(got.shape) == (side.rows, k) and math.isfinite(err)
                    and scale > 0 and err <= REL_TOL * scale):
                fail(f"{label} {name} {sname}: error {err} against scale {scale}")
            if timed:
                A, nnz = _class_csr(side, cls)
                lib = torch.sparse.mm(A, D)
                lerr = float((lib - want).abs().max())
                if not lerr <= 1e-4 * scale:
                    fail(f"{label} {name} {sname}: yardstick disagrees ({lerr})")
                bound_ms, by, nbytes, flops, n_items = _bound(side, cls, k, nnz)
                r.update(
                    ms=time_ms(lambda: kern(side, D)),
                    plain_ms=time_ms(lambda: plain(side, D), reps=3),
                    library_ms=time_ms(lambda: torch.sparse.mm(A, D), reps=3),
                    bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=flops,
                    nnz=nnz, items=n_items,
                )
                r["mnnz_per_s"] = nnz / r["ms"] / 1e3
                del A, lib
            rec[name][sname] = r
            del got, want
    return rec


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


def solve_main_path(X, W0, H0):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent

    out = {}
    xsq = float(X.stats[1])

    # (a) through the front door, 5 traced iterations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = nt.nnmf(X, K, alg="cd", init="custom", W0=W0, H0=H0, tol=1e-30,
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
    upd, _ = CoordinateDescent(maxiter=100)._resolved(torch.float32)
    Xr, w, h, perms = common.renumbered_problem(
        X, torch.from_numpy(W0).cuda(), torch.from_numpy(H0).cuda()
    )
    state = common._prepare(upd, Xr, w, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = 0
    obj, r = relerr_of(Xr, w, h, xsq)
    traj = [(0, obj, r)]
    while not r <= TARGET_RELERR and iters < 60:
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
    if not r <= TARGET_RELERR:
        fail(f"relative error {r} after {iters} iterations, target {TARGET_RELERR}")
    return out


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


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script only runs on the card")
    import nmf_tpu_torch  # noqa: F401  (TF32 off)
    from nmf_tpu_torch.ops.cuda import build
    from nmf_tpu_torch.ops.cuda import sparse as S
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
    say("kernels_small", shape=[3000, 2500], nnz=len(vs), tolerance=REL_TOL,
        rel_err={kk: {n: {s: r["rel_err"] for s, r in d.items()}
                      for n, d in v.items()} for kk, v in small.items()})
    del Xs

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
    store = {
        s: {"chunks": int(side.panel_chunks.numel()),
            "chunks_stored": int(side.coords.shape[0]),
            "dense_blocks": int(side.dpanel_blocks.numel()),
            "dense_blocks_stored": side.n_dblocks,
            "band_entries": side.n_coo,
            "max_chunks_in_a_panel": int(side.panel_ptr.diff().max()),
            "max_blocks_in_a_panel": int(side.dpanel_ptr.diff().max())}
        for s, side in (("fwd", X.fwd), ("bwd", X.bwd))
    }
    say("store", shape=[P, N], nnz=len(vals), k=K, binner="numpy",
        data_seconds=t_data, host_build_seconds=t_build, **store)
    del rows, cols

    full = check_kernels(X, K, "full store", timed=True)
    say("kernels", tolerance=REL_TOL, card=smi, **full)

    # 4. the main path
    say("small_problem", **small_problem_check())
    torch.cuda.reset_peak_memory_stats()
    S.reset_launch_counts()
    solved = solve_main_path(X, W0, H0)
    launches = S.launch_counts()
    solved["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    solved["launches"] = launches
    say("solve", target=TARGET_RELERR, card=smi, **solved)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    say("iteration_parts", card=smi, **time_iteration_parts(X, W0, H0))

    # 5. the report
    meta = {
        "chunk_matmul": ("nmf_tpu_torch/csrc/chunk_matmul.cu",
                         "nmf_tpu/ops/pallas/sparse.py:329"),
        "dense_matmul": ("nmf_tpu_torch/csrc/dense_matmul.cu",
                         "nmf_tpu/ops/pallas/sparse.py:624"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        sides = full[name]
        tot = lambda key: sum(s[key] for s in sides.values())
        # one HALS iteration launches the kernel once per orientation: the
        # times and the bound are sums over the two orientations
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in sides.values()),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": max(sides.values(), key=lambda s: s["bound_ms"])["bound_by"],
            "library_ms": tot("library_ms"),
            "fwd_ms": sides["fwd"]["ms"], "bwd_ms": sides["bwd"]["ms"],
        })
    say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
