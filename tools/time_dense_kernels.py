#!/usr/bin/env python3
"""Time the dense-X kernels (the objective, ``mu_factor_update``, ``wtq``,
``qht``) of one checkout of the PyTorch build, so that two checkouts can be
compared on one card in one run.

    python3 tools/time_dense_kernels.py [TREE]

``TREE`` is the root of a checkout (default: this one); its
``nmf_tpu_torch`` package and its ``chip_smoke.check_dense_kernels`` are
imported, its kernels built, and each kernel timed on the dense
100,000 x 10,000 rank-64 problem of ``chip_smoke.py`` (seed 0), L2 flushed,
median of 5, and ``wtq`` and ``qht`` with their walks cut into other
numbers of runs (``walk``: the wrapper's cut and ``ms_by_runs``; the
objective's too, where the tree cuts its walk) and a hash of each
result's bits; ``mu_factor_update`` (kernel 7) also at ttt1's 500 x 500,
k 8 (both steps, by ``time_ms`` and by its device time alone: 100 launches
as one CUDA graph, replayed) and hashed at every shape ``chip_smoke.py``
and the card tests give it (``bits_mu``); then seconds per iteration of the
bare multiplicative-update loop, both objectives, on the same problem.
Prints one JSON line with the card's name and power limit.
Run two trees in turns (A, B, B, A) in one call to compare them."""

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

# (k, m): kernel 7's shapes beyond the dense problem's -- ttt1, the ragged
# dense check, chip_smoke.check_k_ceilings and the card tests' edges
MU_SHAPES = [(8, 500), (5, 777), (5, 1000), *((k, m) for k in (183, 373, 437, 512)
                                               for m in (260, 300)),
             *((k, m) for k in (1, 3, 8, 63, 64, 65, 129, 450) for m in (333, 1028))]


def _bits(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _graph_ms(fn, launches=100):
    """Device milliseconds of one ``fn()``: ``launches`` calls captured as
    one CUDA graph, replayed between two events, median of 5 replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    graph.replay()
    out = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def _factor_update(cs, M, delta):
    """Kernel 7's bits at ``MU_SHAPES`` (both layouts, seeded operands) and
    its times at ttt1."""
    bits, times = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for k, m in MU_SHAPES:
        F = torch.rand(k, m, device="cuda", generator=gen)
        G = torch.rand(k, k, device="cuda", generator=gen) / k
        C = torch.rand(k, m, device="cuda", generator=gen) - 0.1
        for layout, args in (("rows", (F, G, C)),
                             ("trans", (F.T.contiguous().T, G, C.T.contiguous().T))):
            bits[f"{k}x{m}_{layout}"] = _bits(M.mu_factor_update(*args, 0.01, delta))
    rng = np.random.default_rng(0)
    X = torch.from_numpy(cs._lowrank_noisy(rng, 500, 500, 8)).cuda()
    W = torch.from_numpy(rng.random((500, 8), dtype=np.float32)).cuda()
    H = torch.from_numpy(rng.random((8, 500), dtype=np.float32)).cuda()
    for side, args in (("H", (H, W.T @ W, W.T @ X)), ("W", (W.T, H @ H.T, (X @ H.T).T))):
        run = lambda args=args: M.mu_factor_update(*args, 0.01, delta)  # noqa: E731
        bits[f"ttt1_{side}"] = _bits(run())
        times[f"ttt1_{side}"] = {"ms": cs.time_ms(run), "graph_ms": _graph_ms(run)}
    return bits, times


def main():
    tree = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    rng = np.random.default_rng(0)
    X = cs._lowrank_noisy_on_card(rng, cs.DP, cs.DN, cs.DK)
    W = torch.from_numpy(rng.random((cs.DP, cs.DK), dtype=np.float32)).cuda()
    H = torch.from_numpy(rng.random((cs.DK, cs.DN), dtype=np.float32)).cuda()
    rec = cs.check_dense_kernels(X, W, H, str(tree), timed=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ms = {"wtq": rec["wtq"]["ms"], "qht": rec["qht"]["ms"]}
    ms.update({f"objective_{kind}": r["ms"] for kind, r in rec["dense_objective"].items()})
    ms.update({f"mu_factor_update_{side}": r["ms"]
               for side, r in rec["mu_factor_update"].items()})
    runs = {name: {"runs": rec[name].get("runs"), "ms_by_runs": rec[name].get("ms_by_runs")}
            for name in ("wtq", "qht")}
    # a tree whose objective cuts no walk reports none
    runs.update({f"objective_{kind}": {"runs": r.get("runs"), "ms_by_runs": r.get("ms_by_runs")}
                 for kind, r in rec["dense_objective"].items()})
    from nmf_tpu_torch.models.multupd import MultUpdate
    from nmf_tpu_torch.ops.cuda import mu as M
    from nmf_tpu_torch.ops.cuda import objectives as O
    from nmf_tpu_torch.utils.dtypes import sqrt_eps

    # the bits of each result, to compare trees by
    delta = sqrt_eps(torch.float32)
    outs = {"wtq": M.wtq(X, W, H, delta), "qht": M.qht(X, W, H, delta),
            "objective_mse": O.mse_objective_kernel(X, W, H),
            "objective_kl": O.kl_objective_kernel(X, W, H)}
    G_h, C_h = W.T @ W, W.T @ X
    G_w, C_w = H @ H.T, X @ H.T
    outs["mu_factor_update_H"] = M.mu_factor_update(H, G_h, C_h, 0.01, delta)
    outs["mu_factor_update_W"] = M.mu_factor_update(W.T, G_w, C_w.T, 0.01, delta)
    del G_h, C_h, G_w, C_w
    bits = {name: _bits(t) for name, t in outs.items()}
    bits_mu, ttt1 = _factor_update(cs, M, delta)
    iteration = {obj: cs._seconds_per_iteration(X, MultUpdate(obj=obj), W, H, 5)
                 for obj in ("div", "mse")}
    print(json.dumps({"tree": str(tree), "card": smi, "shape": [cs.DP, cs.DN],
                      "k": cs.DK, "ms": ms, "walk": runs, "bits": bits,
                      "bits_mu": bits_mu, "ttt1": ttt1,
                      "ms_by_width": {side: r.get("ms_by_width")
                                      for side, r in rec["mu_factor_update"].items()},
                      "seconds_per_iteration": iteration}), flush=True)


if __name__ == "__main__":
    main()
