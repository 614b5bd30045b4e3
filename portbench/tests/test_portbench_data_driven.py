"""A cell, a configuration and a metric reader added as files and
``BENCHMARK.json`` entries, in a copy of the benchmark, are found and run
with no edit to a file that is there; the command refuses to run without a
card, and prints no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from pb_support import ROOT

from portbench import harness
from portbench.manifest import load_cell

READER = '''"""tmp_iters_per_solve: iterations a solve of the window ran."""


def read(ctx):
    return sum(a.niters for _, a in ctx.solves) / len(ctx.solves)
'''


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def add_cell(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    (pb / "configs" / "tmp-dense.json").write_text(json.dumps(
        {"generator": "lowrank_noisy", "rows": 300, "cols": 200, "signal_rank": 4,
         "noise": 0.01, "rank": 4, "dtype": "float32"}))
    (pb / "limits" / "tmp-cell.json").write_text(json.dumps({"w_gap": 1e-5, "h_gap": 1e-5}))
    (pb / "metrics" / "tmp_iters_per_solve.py").write_text(READER)
    bench["configs"].append({"name": "tmp-dense", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tmp-dense.json", "why": "a test"})
    bench["workloads"].append({"name": "tmp-cell", "config": "tmp-dense", "traffic": "mu-kl-20",
                               "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "solve_s")["workloads"].append("tmp-cell")
    bench["per_layer"].append({"name": "tmp_iters_per_solve", "unit": "iters", "better": "lower",
                               "source": "program_counter", "layer": "solver",
                               "moves": "solve_s", "workloads": ["tmp-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_and_run(copy):
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*") if p.is_file()}
    add_cell(copy)
    assert all(p.read_bytes() == b for p, b in before.items())
    cell = load_cell("tmp-cell", root=copy)
    assert cell.per_layer[-1] == "tmp_iters_per_solve"
    traced = harness.run_cell(cell, 17, 0.1, trace=True, device="cpu")
    assert traced["correct"] and traced["metrics"]["tmp_iters_per_solve"] == 20
    plain = harness.run_cell(cell, 17, 0.1, trace=False, device="cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"solve_s", "setup_s"}


def run_command(root, workload):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result(copy):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    (copy / "nmf_tpu_torch").symlink_to(ROOT / "nmf_tpu_torch")
    out = run_command(copy, "ml25m-kl")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(copy):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no program to measure."""
    out = run_command(copy, "dense-kl")
    assert out.returncode != 0 and out.stdout == ""
