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
result's bits; then
seconds per iteration of the bare multiplicative-update loop, both
objectives, on the same problem.  Prints one JSON line with the card's name
and power limit.
Run two trees in turns (A, B, B, A) in one call to compare them."""

import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch


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
    bits = {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
            for name, t in outs.items()}
    iteration = {obj: cs._seconds_per_iteration(X, MultUpdate(obj=obj), W, H, 5)
                 for obj in ("div", "mse")}
    print(json.dumps({"tree": str(tree), "card": smi, "shape": [cs.DP, cs.DN],
                      "k": cs.DK, "ms": ms, "walk": runs, "bits": bits,
                      "seconds_per_iteration": iteration}), flush=True)


if __name__ == "__main__":
    main()
