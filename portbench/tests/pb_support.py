"""What the benchmark's tests share: the checkout on ``sys.path``, the
fixture that skips without a card, and the cells cut to sizes a CPU test
holds.

Run the tests from the checkout's root: ``python -m pytest portbench/tests
-q``; those marked ``gpu`` skip without a card."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.manifest import Cell, _read, load_cell  # noqa: E402

# each configuration at a size a test holds, of the same kind and options
SIZES = {
    "ml25m-k128": dict(rows=2000, cols=1000, nnz=60000, rank=16),
    "dense100k-k64": dict(rows=700, cols=300, signal_rank=8, rank=8),
    # k 128: at smaller k the control's gaps stay under the cell's limits
    "northstar-2x2-k256": dict(rows=4000, cols=2000, nnz=200000, rank=128),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda", 0)


def bench() -> dict:
    return _read(ROOT / "BENCHMARK.json")


def cell_names() -> list:
    return [w["name"] for w in bench()["workloads"]]


def tiny_cell(name: str) -> Cell:
    """Cell ``name`` with its traffic and limits, on a small matrix."""
    cell = load_cell(name)
    config = {w["name"]: w["config"] for w in bench()["workloads"]}[name]
    cell.config = dict(cell.config, **SIZES[config])
    return cell


def run_tiny(name: str, seed: int, seconds: float, trace: bool = False) -> dict:
    """A run of cell ``name`` on its small matrix in this process, on the
    CPU; a cell cut over a mesh on a mesh of one process, every cell of it
    on the CPU."""
    from portbench import harness, ranks
    from nmf_tpu_torch.parallel.mesh import make_mesh

    cell = tiny_cell(name)
    if "mesh" not in cell.config:
        return harness.run_cell(cell, seed, seconds, trace=trace, device="cpu")
    R, C = cell.config["mesh"]
    return ranks.run_ranks(cell, seed, seconds, trace,
                           make_mesh((R, C), devices=["cpu"] * (R * C)))
