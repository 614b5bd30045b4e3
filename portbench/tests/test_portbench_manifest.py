"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs present."""

import re

import pytest

from pb_support import ROOT, bench, cell_names

from portbench.manifest import load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51


def test_names_and_units_use_only_allowed_characters():
    b = bench()
    entries = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_roofline_and_mfu_names():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


@pytest.mark.parametrize("name", cell_names())
def test_cell_files_are_found(name):
    cell = load_cell(name)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    cell.module("generators", cell.config["generator"])
    cell.module("reference", cell.traffic["alg"])
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", metric).read)
    assert cell.limits


def test_every_config_is_used():
    b = bench()
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
