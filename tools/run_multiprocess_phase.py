#!/usr/bin/env python3
"""The ``multiprocess`` phase of ``chip_smoke.py`` alone, for a host with
several cards: ``python3 tools/run_multiprocess_phase.py``.

It makes the ttt4 matrix and the ttt3 one from ``chip_smoke.py``'s seeds,
takes the one-process 2 x 2 meshes' digests on ``cuda:0``, then runs
``chip_smoke.multiprocess_phase``: two processes over gloo on ``cuda:0``
and, with two or more cards, two over NCCL on ``cuda:0`` and ``cuda:1``,
each rank held to the one-process bits.  It prints the phase's JSON line
and the card's name and power limit; it fails without a card.
"""

import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script only runs on the card")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load_kernels()
    rows, cols, vals = cs._movielens_like(np.random.default_rng(0))
    mesh = nt.make_mesh((2, 2), devices=["cuda:0"] * 4)
    Xm = nt.shard_tiled(rows, cols, vals, (cs.P, cs.N), mesh, dense_tile_nnz=192,
                        coo_tail_nnz=3)
    sparse_ref = cs.multiprocess_sparse_runs(Xm, mesh)
    del Xm
    Xd = cs._lowrank_noisy_on_card(np.random.default_rng(0), cs.DP, cs.DN, cs.DK)
    dense_ref = cs.multiprocess_dense_runs(nt.shard_dense(Xd, mesh), mesh)
    del Xd
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="multiprocess_") as tmp:
        data = pathlib.Path(tmp) / "ttt4_coo.npz"
        np.savez(data, rows=rows, cols=cols, vals=vals)
        t0 = time.perf_counter()
        out = cs.multiprocess_phase(data, sparse_ref, dense_ref)
    cs.say("multiprocess", card=smi, count=torch.cuda.device_count(),
           seconds=time.perf_counter() - t0, **out)
    cs.say("total", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
