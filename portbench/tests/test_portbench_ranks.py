"""The harness's path for a cell cut over a mesh, as ``run.py`` starts it on
four cards, here as four gloo processes on the CPU: a (2, 2) mesh of about
300 x 200 blocks, k 8, 3 HALS iterations a solve, a 2 s window, in a copy
of the benchmark with a cell of its own.  Every rank runs the same solves,
rank 0 alone prints one result line, ``correct`` and the peak (the largest
of the ranks') are as they should be; an answer altered where it is
produced, and the exchange between the processes left out, read not
correct; a rank that raises ends every rank, none hangs.

Every launcher runs under ``communicate(timeout=...)``; the launcher ends
the other ranks as soon as one fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from pb_support import ROOT

CELL = "tmp-mesh"
SEED = 2**31 + 101
PARTS = "set-up parts, and the window's solves "

FAULTS = {
    None: "",
    "altered": '''
import nmf_tpu_torch as nt
nnmf = nt.nnmf
def wrong(*args, **kw):
    res = nnmf(*args, **kw)
    W = res.W.clone()
    W[W.sum(1).argmax()] *= 2
    return nt.Result(W, res.H, res.niters, res.converged, res.objvalue)
nt.nnmf = wrong
''',
    "no_exchange": '''
from nmf_tpu_torch.ops import sparse_shard
def own_only(parts, ranks, shapes, lead):
    import torch
    return [[torch.zeros(tuple(shapes[i][j]), device=lead) if part is None else part
             for j, part in enumerate(row)] for i, row in enumerate(parts)]
sparse_shard.gather_cells = own_only
''',
    "raises": '''
import nmf_tpu_torch as nt
nnmf, calls = nt.nnmf, []
def failing(*args, **kw):
    calls.append(1)
    if os.environ["RANK"] == "2" and len(calls) == 3:  # the window's second solve
        raise RuntimeError("a solve that raises on rank 2")
    return nnmf(*args, **kw)
nt.nnmf = failing
''',
}

ENTRY = '''import os, sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench import ranks
ranks.memory_peak = lambda device: 1000 * (int(os.environ["RANK"]) + 1)
{fault}
sys.exit(ranks.rank_main())
'''


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "nmf_tpu_torch").symlink_to(ROOT / "nmf_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    config = json.loads((pb / "configs" / "northstar-2x2-k256.json").read_text())
    config.update(name="tmp-mesh-k8", rows=600, cols=400, nnz=20000, rank=8)
    (pb / "configs" / "tmp-mesh-k8.json").write_text(json.dumps(config))
    (pb / "traffic" / "hals-3.json").write_text(json.dumps(
        {"alg": "cd", "kind": "iterations", "maxiter": 3, "tol": 1e-30}))
    shutil.copy(pb / "limits" / "northstar-share-4x.json", pb / "limits" / f"{CELL}.json")
    bench["configs"].append({"name": "tmp-mesh-k8", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tmp-mesh-k8.json", "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tmp-mesh-k8", "traffic": "hals-3",
                               "chips": 4, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "northstar-share-4x" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for fault, code in FAULTS.items():
        (pb / f"entry_{fault}.py").write_text(ENTRY.format(fault=code))
    return root


def launch(root, fault=None, trace=0):
    code = ("import sys; sys.path.insert(0, '.'); from portbench import ranks; "
            f"sys.exit(ranks.launch({CELL!r}, {SEED}, 2.0, {trace}, 4, backend='gloo', "
            f"script='portbench/entry_{fault}.py'))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        proc.kill()
    return proc.returncode, out, err


def parts(err):
    line = next(x for x in err.splitlines() if x.startswith(PARTS))
    return json.loads(line[len(PARTS):])


@pytest.mark.parametrize("trace", [0, 1])
def test_four_processes_one_result(copy, trace):
    code, out, err = launch(copy, trace=trace)
    assert code == 0, err
    lines = out.splitlines()
    assert len(lines) == 1, out
    res = json.loads(lines[0])
    assert res["correct"] is True and res["failed"] == 0, err
    assert res["device"]["count"] == 4
    ranks = parts(err)["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert {r["solves"] for r in ranks} == {res["attempted"]} and res["attempted"] >= 2
    assert res["device"]["memory_peak_bytes"] == 4000 == max(r["peak_bytes"] for r in ranks)
    # the checks are the last lines of standard error, after every rank's
    checks = err.splitlines()[-len(res["checks"]):]
    assert all(x.startswith("check ") and x.endswith(" ok") for x in checks), err
    assert not any(x.startswith("[rank") for x in err.split("set-up parts")[1].splitlines())
    if trace:
        assert "store_build_s" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"solve_s", "setup_s"}


@pytest.mark.parametrize("fault", ["altered", "no_exchange"])
def test_fault_is_not_correct(copy, fault):
    code, out, err = launch(copy, fault)
    assert code == 0, err
    res = json.loads(out.splitlines()[-1])
    assert res["correct"] is False, res["checks"]


def test_a_rank_that_raises_ends_all(copy):
    code, out, err = launch(copy, "raises")
    assert code != 0 and out == ""
    assert "a solve that raises on rank 2" in err
    assert "rank exit codes" in err
