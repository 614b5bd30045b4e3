"""The readings that a cell's limits are set from, at the cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds <a,b,...>
        [--solves N] [--control M] [--repeat 1] [--lanes 1] [--faults F]
        [--program 0]

For each seed, in one process: the cell's data, the program's solves from
the window's first N starts (``harness.Solver``, the window's own path),
and the reference from the same starts; the numbers ``check`` compares are
the program's reading.  On the first M solves of a seed the control stands
in the program's place as well: the reference with every product in
TF32
(``reference.common.Products(low=True)``; for a solve to a target, its own
solve to the target, and for restarts the best of its lanes), compared with
the same numbers.  With ``--lanes 1``, for a solve with restarts run as
lanes, each lane of the program (the solve from its own start, and the
restarts through ``solve_lanes``, the batched path that ``nnmf`` takes)
against the reference's lane from the same start: any lane may be the one
that a solve returns.  On the first F solves of a seed, two faults at the
cell's own size: the answer's heaviest row of W doubled (``altered``), and
the solve again with every product with X seeing the first half of the
shared dimension, doubled (``half_batch``).  A cell cut over a mesh is read
on one card (``ranks.read_seed``); with ``--program 0`` the control alone,
where its blocks do not fit one card together.  One JSON line a solve on
standard output, and in ``chiprun_out/readings_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import check, harness, manifest  # noqa: E402
from portbench.common import sync  # noqa: E402
from portbench.reference import common as refc  # noqa: E402


def control_answer(cell, X, lanes, iters):
    """The control's (W, H, iterations): the lower-precision reference from
    the control's starts (the window's own, or ``nnmf``'s init worked out in
    the control's precision), its best lane by the exact objective."""
    ref = cell.module("reference", cell.traffic["alg"])
    if cell.traffic["kind"] == "target":
        W, H = lanes[0]
        return check.solve_target(ref, X, W.clone(), H.clone(), cell.traffic, refc.Products(True))
    low = check.answers(cell, X, lanes, iters, low=True)
    objs = [ref.objective(X, w, h) for w, h in low]
    best = min(range(len(objs)), key=lambda j: objs[j] if objs[j] == objs[j] else float("inf"))
    return (*low[best], iters)


def lane_readings(cell, nt, X, Xref, lanes, exact, ans_lane0, iters):
    """The numbers of each lane of the program against the reference's
    lane from the same start."""
    from nmf_tpu_torch.models.replicates import solve_lanes

    tr = cell.traffic
    alg = {"cd": nt.CoordinateDescent, "greedycd": nt.GreedyCD}[tr["alg"]]
    Ws = torch.stack([w for w, _ in lanes[1:]])
    Hs = torch.stack([h for _, h in lanes[1:]])
    prog = [ans_lane0] + [(w, h) for w, h, *_ in
                          solve_lanes(alg(maxiter=iters, tol=tr["tol"]), X, Ws, Hs,
                                      device=Ws.device)]
    return [check.numbers(cell, Xref, w, h, [exact[j]]) for j, (w, h) in enumerate(prog)]


def halved(mm, mtm):
    """``mm`` and ``mtm`` that see the first half of the shared dimension,
    doubled: half of the batch left out, the rest scaled up in its place."""

    def half(n, like):
        keep = torch.zeros(n, dtype=like.dtype, device=like.device)
        keep[: n // 2] = 2
        return keep

    return (lambda X, D: mm(X, D * half(D.shape[0], D)[:, None]),
            lambda D, X: mtm(D * half(D.shape[1], D)[None, :], X))


def half_batch_answer(solve, W0, H0, seed):
    """The solve with every product with X ``halved``."""
    from nmf_tpu_torch.ops import matops

    mm, mtm = matops.mm, matops.mtm
    matops.mm, matops.mtm = halved(mm, mtm)
    try:
        return solve(W0, H0, seed)
    finally:
        matops.mm, matops.mtm = mm, mtm


def read_seed(cell, seed, device, control: int, solves: int = 1, repeat: bool = False,
              lanes_too: bool = False, faults: int = 0, program: bool = True):
    """The readings of ``solves`` solves of one seed's data (the window's
    solves 0, 1, ...), the control on the first ``control`` of them, the
    faults on the first ``faults``; with ``repeat``, the first solve and
    its reference are run twice and compared bit for bit; with
    ``lanes_too``, each lane of a solve with restarts.  A cell cut over a
    mesh is read by ``ranks.read_seed``: the program (unless not
    ``program``) and the control."""
    if "mesh" in cell.config:
        from portbench import ranks

        return ranks.read_seed(cell, seed, device, control, solves, program)
    import nmf_tpu_torch as nt

    data = cell.module("generators", cell.config["generator"]).make(cell.config, seed, device)
    Xref = refc.operand(data)
    X, xsq, _ = harness.prepare_operand(cell, dict(data), device, {})
    shape, k = data["shape"], cell.config["rank"]
    solve = harness.Solver(nt, X, k, cell.traffic, device, xsq)
    lines = []
    for index in range(solves):
        W0, H0 = harness.solve_start(cell.traffic, shape, k, device, seed, index)
        t = time.perf_counter()
        ans = solve(W0, H0, harness.nnmf_seed(seed, index))
        sync(device)
        out = {"cell": cell.name, "seed": seed, "index": index,
               "program_s": time.perf_counter() - t, "program_iters": ans.niters}
        lanes = check.lane_starts(cell, shape, seed, index, device, Xref)
        iters = check.iterations(cell.traffic, ans)
        t = time.perf_counter()
        exact = check.answers(cell, Xref, lanes, iters, low=False)
        out["program"] = check.numbers(cell, Xref, ans.W, ans.H, exact)
        out["reference_s"] = time.perf_counter() - t
        if lanes_too and len(lanes) > 1:
            single = nt.nnmf(X, k, W0=W0, H0=H0, maxiter=iters, alg=cell.traffic["alg"],
                             init="custom", tol=cell.traffic["tol"], device=device)
            out["lanes"] = lane_readings(cell, nt, X, Xref, lanes, exact,
                                         (single.W, single.H), iters)
        if index < faults:
            W = ans.W.clone()
            W[W.sum(1).argmax()] *= 2
            out["altered"] = check.numbers(cell, Xref, W, ans.H, exact)
            bad = half_batch_answer(solve, W0, H0, harness.nnmf_seed(seed, index))
            out["half_batch"] = check.numbers(cell, Xref, bad.W, bad.H, exact)
        if repeat and index == 0:
            again = solve(W0, H0, harness.nnmf_seed(seed, index))
            out["program_same_bits"] = bool(torch.equal(again.W, ans.W)
                                            and torch.equal(again.H, ans.H))
            twice = check.answers(cell, Xref, lanes, iters, low=False)
            out["reference_same_bits"] = all(
                torch.equal(a, b) for x, y in zip(exact, twice) for a, b in zip(x, y))
        if index < control:
            low = check.lane_starts(cell, shape, seed, index, device, Xref, low=True)
            Wc, Hc, it_c = control_answer(cell, Xref, low, iters)
            if it_c != iters:
                exact = check.answers(cell, Xref, lanes, it_c, low=False)
            out["control"] = check.numbers(cell, Xref, Wc, Hc, exact)
            out["control_iters"] = it_c
        lines.append(out)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--solves", type=int, default=1, help="solves a seed")
    ap.add_argument("--control", type=int, default=0,
                    help="read the control too on the first this many solves of a seed")
    ap.add_argument("--repeat", type=int, choices=(0, 1), default=0,
                    help="run each seed's first solve and its reference twice")
    ap.add_argument("--lanes", type=int, choices=(0, 1), default=0,
                    help="read each lane of a solve with restarts")
    ap.add_argument("--faults", type=int, default=0,
                    help="read the faults on the first this many solves of a seed")
    ap.add_argument("--program", type=int, choices=(0, 1), default=1,
                    help="0: the control alone, for a cell cut over a mesh whose blocks "
                         "do not fit one card together")
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    from nmf_tpu_torch.ops.cuda import build

    build.load_kernels()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / f"readings_{cell.name}.jsonl", "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            for out in read_seed(cell, seed, device, args.control, args.solves,
                                 bool(args.repeat), bool(args.lanes), args.faults,
                                 bool(args.program)):
                line = json.dumps(out)
                print(line, flush=True)
                f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
