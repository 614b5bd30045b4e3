#!/usr/bin/env python3
"""One benchmark cell run on many seeds in one process, for the numbers
that decide ``correct`` over many seeds and the kernels a solve launches:

    python3 tools/portbench_seeds.py WORKLOAD SEEDS [FIRST] [SECONDS]

Runs ``portbench.harness.run_cell`` (the benchmark's own run, untraced) for
``SEEDS`` seeds ``FIRST``, ``FIRST + 1000003``, ... (default ``FIRST``
2,147,483,659, above 32 signed bits as the driver's are) with a window of
``SECONDS`` (default 1: one solve, kept and checked).  Prints one JSON line
a seed: ``correct``, the checks, the window's solves and their seconds,
and the port's kernel launches by name over the run (set-up, the
2-iteration warm-up solve and the window).  Then one line with the
largest value of each number over the seeds, beside its limit and the seed
that gave it, and the card's name and power limit.  Needs the card, like
``portbench/run.py``."""

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, manifest  # noqa: E402


def main():
    cell = manifest.load_cell(sys.argv[1])
    seeds = int(sys.argv[2])
    first = int(sys.argv[3]) if len(sys.argv) > 3 else 2_147_483_659
    seconds = float(sys.argv[4]) if len(sys.argv) > 4 else 1.0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card")
    from nmf_tpu_torch.ops.cuda import build

    worst = {}
    for i in range(seeds):
        seed = first + 1_000_003 * i
        build.reset_launch_counts()
        res = harness.run_cell(cell, seed, seconds, trace=False)
        counts = {k: v for k, v in build.launch_counts().items() if v}
        solves = len(res["spans"]["window_solves_s"])
        line = {"seed": seed, "correct": res["correct"], "failed": res["failed"],
                "solves": solves, "solve_s": res["spans"]["window_solves_s"],
                "checks": res["checks"], "launches": counts}
        print(json.dumps(line), flush=True)
        for name, c in res["checks"].items():
            v = c["value"] if c["value"] is not None else float("inf")
            if v >= worst.get(name, (-1.0, None))[0]:
                worst[name] = (v, c["limit"], seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"workload": cell.name, "seeds": seeds, "card": smi.strip(),
                      "worst": {n: {"value": v, "limit": lim, "seed": s}
                                for n, (v, lim, s) in worst.items()}}), flush=True)


if __name__ == "__main__":
    main()
