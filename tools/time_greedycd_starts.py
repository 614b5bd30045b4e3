#!/usr/bin/env python3
"""Iterations and seconds GreedyCD (the ``nnmf`` default solver), or with
``hals`` Fast-HALS, takes to relative error 0.84 on the 163,000 x 59,000
problem of ``chip_smoke.py``, from several random starts, for one checkout
of the PyTorch build, so that two checkouts can be compared on one card in
one run:

    python3 tools/time_greedycd_starts.py [TREE] [SEEDS] [hals]

``TREE`` is the root of a checkout (default: this one); its ``nmf_tpu_torch``
package and its ``chip_smoke`` helpers are imported.  The matrix (seed 0,
kept in ``_cache/`` beside this script's checkout, ignored by git) is built
as the chunk store; each start is ``W0, H0`` uniform from numpy seed
``100 + s`` for s < SEEDS (default 3).  From each start the resumable loop
runs in chunks of 5 iterations, one relative-error read a chunk, until the
target or 200 iterations.  Prints one JSON line with the card's name and
power limit."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from time_sparse_kernels import _matrix  # noqa: E402


def main():
    tree = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    seeds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from nmf_tpu_torch.models import common
    from nmf_tpu_torch.models.coorddesc import CoordinateDescent
    from nmf_tpu_torch.models.greedycd import GreedyCD
    from nmf_tpu_torch.ops import sparse_format as sf

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    rows, cols, vals = _matrix(cs)
    X = sf.build_tiled(rows, cols, vals, (cs.P, cs.N), dense_tile_nnz=192, coo_tail_nnz=3)
    xsq = float(X.stats[1])
    hals = sys.argv[3:] == ["hals"]
    out = {"tree": str(tree), "solver": "hals" if hals else "greedycd",
           "target": cs.TARGET_RELERR, "starts": []}
    for s in range(seeds):
        rng = np.random.default_rng(100 + s)
        W0 = torch.from_numpy(rng.random((cs.P, cs.K), dtype=np.float32)).cuda()
        H0 = torch.from_numpy(rng.random((cs.K, cs.N), dtype=np.float32)).cuda()
        Xr, w, h, _ = common.renumbered_problem(X, W0, H0)
        upd = (CoordinateDescent(maxiter=100)._resolved(torch.float32)[0] if hals
               else GreedyCD(maxiter=100))
        state = common._prepare(upd, Xr, w, h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iters, r = 0, cs.relerr_of(Xr, w, h, xsq)[1]
        traj = [(0, r)]
        while not r <= cs.TARGET_RELERR and iters < 200:
            w, h, state, t, _, _ = common._solve_while_from(
                upd, state, Xr, w, h, 0, 5, 1e-30, with_objective=False)
            iters += t
            r = cs.relerr_of(Xr, w, h, xsq)[1]
            traj.append((iters, r))
        torch.cuda.synchronize()
        out["starts"].append({
            "seed": 100 + s, "iterations": iters, "relerr": r,
            "seconds": time.perf_counter() - t0, "trajectory": traj})
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
