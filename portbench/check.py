"""The check that decides ``correct``: the window's kept solve against the
plain reference, solved again from the same start on data drawn again from
the seed.

The reference solves each start that the program's solve began from: the
solve's own start (the window's ``W0``, ``H0``, or, where the traffic names
``nnmf``'s own NNDSVD ``init``, that init worked out again from the solve's
``seed`` by ``reference/nndsvd.py``) and, for ``replicates`` r > 1, the r - 1 restarts
that ``nnmf`` draws from its ``seed`` (``reference/restarts.py``), each for
as many iterations as the program ran (``maxiter``, or the kept solve's
count for a solve to a target or one that stops at ``nnmf``'s own ``tol``),
in float32, or in the ``DTYPE`` that its module states (HALS, GreedyCD:
float64).  Compared, each against its limit in ``limits/<cell>.json``:

- ``w_gap``, ``h_gap``: ``||F - F_ref||_F / ||F_ref||_F`` of each factor,
  against the reference's lane nearest to the answer's W;
- ``obj_gap``: the reference's objective of the answer's factors against
  the least of its own lanes' objectives, relative (where the objective
  is finite: KL updates drive rare columns of H to 0, and the divergence
  of an entry whose ``W H`` is 0 is infinite);
- ``relerr`` (a solve to a target): the reference's ``||X - W H|| / ||X||``
  of the answer, whose limit is the target itself;
- ``w_gap_median_col``, ``h_gap_median_row`` (and the worst): the same gap
  taken a component at a time, the median (the largest) over the k
  components.

A cell compares the numbers its limits file names.

A number that is not finite fails.  ``answers`` also serves the control,
which puts the reference in lower precision in the program's place.
"""

from __future__ import annotations

import math

import torch

from portbench.harness import draw_start, nnmf_seed
from portbench.reference import common as refc
from portbench.reference.restarts import starts as restart_starts


def gap(a, b) -> float:
    a, b = a.double().to(b.device), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def column_gaps(a, b, dim):
    """The gap of each component (W's columns: ``dim`` 0; H's rows: 1)."""
    a, b = a.double().to(b.device), b.double()
    return (torch.linalg.vector_norm(a - b, dim=dim)
            / torch.linalg.vector_norm(b, dim=dim).clamp_min(1e-300))


def lane_starts(cell, shape, seed, index, device, X=None, low: bool = False):
    """The starts of the solve named by ``index``; ``X``, the reference's
    operand, is needed where ``nnmf`` makes the first start itself, and
    with ``low`` that start is the control's, in the control's
    precision."""
    k = cell.config["rank"]
    init = cell.traffic.get("init", "custom")
    if init == "custom":
        lanes = [draw_start(shape, k, device, seed, index)]
    else:
        ref = cell.module("reference", "nndsvd")  # raises for an init it lacks
        lanes = [ref.start(init, X, k, nnmf_seed(seed, index), device,
                           zeroh=cell.traffic["alg"] == "projals", low=low)]
    reps = cell.traffic.get("replicates", 1)
    if reps > 1:
        lanes += restart_starts(nnmf_seed(seed, index), *shape, k, reps - 1, device)
    return lanes


def solve_target(ref, X, W, H, traffic, prod):
    """A solve to the target by the reference itself, in ``chunk`` steps
    (the control's stand-in for the program's); returns (W, H, iters)."""
    iters = 0
    while True:
        W, H = ref.solve(X, W, H, traffic["chunk"], prod)
        iters += traffic["chunk"]
        rel = refc.relerr(X, W, H)
        if not math.isfinite(rel) or rel <= traffic["target_relerr"] or iters >= traffic["cap"]:
            return W, H, iters


def iterations(traffic, ans) -> int:
    """The iterations the reference runs: the kept solve's own count where
    it decides when to stop (a target, or ``nnmf``'s own ``tol``), else
    the traffic's ``maxiter``."""
    if traffic["kind"] == "target" or traffic["tol"] is None:
        return ans.niters
    return traffic["maxiter"]


def answers(cell, X, lanes, iters, low: bool):
    """The reference's final factors from each start: in the reference's
    own ``DTYPE`` where it states one, else in float32, and the control
    (``low``) in float32."""
    ref = cell.module("reference", cell.traffic["alg"])
    prod = refc.Products(low)
    dtype = torch.float32 if low else getattr(ref, "DTYPE", torch.float32)
    return [ref.solve(X, W.to(dtype, copy=True), H.to(dtype, copy=True), iters, prod)
            for W, H in lanes]


def numbers(cell, X, W, H, lanes_out) -> dict:
    ref = cell.module("reference", cell.traffic["alg"])
    objs = [ref.objective(X, w, h) for w, h in lanes_out]
    least = min((o for o in objs if math.isfinite(o)), default=math.nan)
    near = min(range(len(lanes_out)), key=lambda j: gap(W, lanes_out[j][0])) \
        if len(lanes_out) > 1 else 0
    wc = column_gaps(W, lanes_out[near][0], 0)
    hc = column_gaps(H, lanes_out[near][1], 1)
    out = {"w_gap": gap(W, lanes_out[near][0]), "h_gap": gap(H, lanes_out[near][1]),
           "w_gap_median_col": float(wc.median()), "w_gap_worst_col": float(wc.max()),
           "h_gap_median_row": float(hc.median()), "h_gap_worst_row": float(hc.max()),
           "obj_gap": abs(ref.objective(X, W.to(lanes_out[0][0].device),
                                        H.to(lanes_out[0][0].device)) - least) / abs(least)}
    if cell.traffic["kind"] == "target":
        out["relerr"] = refc.relerr(X, W.to(lanes_out[0][0].device), H.to(lanes_out[0][0].device))
    return out


def judged(cell, values: dict) -> dict:
    """Each number that the cell's limits name, beside its limit; a number
    that is not finite is reported as None and fails."""
    limits = dict(cell.limits)
    if cell.traffic["kind"] == "target":
        limits["relerr"] = cell.traffic["target_relerr"]
    return {name: {"value": values[name] if math.isfinite(values[name]) else None,
                   "limit": limit} for name, limit in limits.items()}


def check(cell, seed, kept, device, data=None) -> dict:
    """The kept answer's numbers beside their limits; ``data``, the whole
    matrix, is drawn again from the seed unless given."""
    index, ans = kept
    if data is None:
        data = cell.module("generators", cell.config["generator"]).make(cell.config, seed,
                                                                         device)
    X = refc.operand(data)
    lanes = lane_starts(cell, data["shape"], seed, index, device, X)
    out = answers(cell, X, lanes, iterations(cell.traffic, ans), low=False)
    return judged(cell, numbers(cell, X, ans.W, ans.H, out))


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
