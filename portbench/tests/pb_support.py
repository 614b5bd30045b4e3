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
