"""The port's examples (``examples/torch_*.py``) run on the CPU at small
sizes, all four at once, each in a process of its own (one thread each, so
that they do not crowd each other)."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = {
    "torch_densenmf.py": ["cd", "--device", "cpu"],
    "torch_sparse_nmf.py": ["--device", "cpu", "--p", "300", "--n", "200", "--k", "4"],
    "torch_separable_nmf.py": ["--device", "cpu"],
    "torch_distributed_nmf.py": ["--device", "cpu", "--p", "256", "--n", "192"],
}
EXPECT = {
    "torch_densenmf.py": "rel. error",
    "torch_sparse_nmf.py": "TiledCSR multdiv",
    "torch_separable_nmf.py": "sqL2dist(X, WH)",
    "torch_distributed_nmf.py": "rank 1 sparse  multdiv",
}


def test_the_examples_run_on_the_cpu():
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / name), *args], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in RUNS.items()}
    try:
        outs = {name: p.communicate(timeout=120)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for name, p in procs.items():
        assert p.returncode == 0, outs[name]
        assert EXPECT[name] in outs[name], outs[name]
    # both processes of the distributed example return the same Result
    lines = outs["torch_distributed_nmf.py"].splitlines()
    for kind in ("dense", "sparse"):
        got = {ln.split(kind, 1)[1].split("(")[0] for ln in lines
               if ln.startswith("rank ") and f" {kind} " in ln}
        assert len(got) == 1, lines
