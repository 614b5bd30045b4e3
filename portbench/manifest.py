"""``BENCHMARK.json`` and the files the harness finds by the names in it.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's ``file`` holds the matrix's sizes and the generator that
draws it (``generators/<generator>.py``); the traffic mix is
``traffic/<traffic>.json``, the solve that each call of the window makes,
and its ``alg`` names the plain solver (``reference/<alg>.py``); the cell's
limits on what ``correct`` compares are ``limits/<cell>.json``; each metric
is read by ``metrics/<metric>.py``.  A later cell, configuration, mix or
metric is new files and new entries, with no edit to a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric names this cell reports with --trace 0
    per_layer: list  # and with --trace 1
    units: dict  # of every metric
    root: Path

    def module(self, folder: str, name: str):
        return load_module(self.root / "portbench" / folder / f"{name}.py")


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return Cell(
        name=name,
        chips=cell["chips"],
        config=_read(root / config["file"]),
        traffic=_read(root / "portbench" / "traffic" / f"{cell['traffic']}.json"),
        limits=_read(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m["name"] for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m["name"] for m in bench["per_layer"] if _applies(m, name)],
        units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
        root=root,
    )


def load_module(path: Path):
    """A module loaded from its file, under a name made from its path."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
