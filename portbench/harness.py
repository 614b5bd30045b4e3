"""One run of one cell: set-up, the window, the traced solve, the metrics,
and the check against the plain reference.

The window is a closed loop with one caller: whole solves back to back
until ``seconds`` have passed; the solve under way when time runs out is
finished and counted.  Solve i starts from its own ``W0``, ``H0``, drawn on
the device from (seed, i) before its clock starts, or, where the traffic
mix names ``nnmf``'s own ``init``, from that init, which runs inside the
timed call from the solve's own ``seed`` as it does for a user; it calls
``nmf_tpu_torch.nnmf`` as the traffic mix says:

- ``iterations``: one call of ``maxiter`` iterations with the mix's ``tol``,
  one that no solve meets, or, where it is null, ``nnmf``'s own (every mix
  states ``tol``);
- ``target``: calls of ``chunk`` iterations, each from where the last
  stopped, until the relative error ``sqrt(2 mse) / ||X||`` (read through
  the program's ``mse_objective`` after each call) reaches
  ``target_relerr``, or ``cap`` iterations have run.

Each solve ends with a synchronize.  One solve of the window, drawn from the
seed as the window goes (a reservoir of one), is kept on the host, and once
the program's state is freed the reference solves again from the same start
on data it draws again from the seed, and the two are compared.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from portbench.common import generator, mix, sync
from portbench.manifest import Cell


@dataclass
class Answer:
    W: torch.Tensor
    H: torch.Tensor
    niters: int
    calls: int = 1
    relerr: float | None = None


@dataclass
class Context:
    """What the metric readers read."""

    cell: Cell
    device: torch.device
    nt: object  # the program, ``nmf_tpu_torch``
    X: object  # the program's operand: the store, or the dense tensor
    shape: tuple
    nnz: int | None
    k: int
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    solves: list = field(default_factory=list)  # (seconds, Answer without factors)
    peak_bytes: int = 0
    trace: dict | None = None
    last: Answer | None = None

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def lanes(self) -> int:
        """Starts stepped side by side in a batched solve's products."""
        tr = self.cell.traffic
        reps = tr.get("replicates", 1)
        return reps - 1 if reps > 1 and tr.get("parallel_replicates") else 1


def draw_start(shape, k, device, seed, *index):
    """The start of the solve named by ``index``: uniform on [0, 1), drawn
    on the device."""
    p, n = shape
    gen = generator(device, seed, "start", *index)
    W = torch.rand((p, k), generator=gen, device=device)
    H = torch.rand((k, n), generator=gen, device=device)
    return W, H


def solve_start(traffic, shape, k, device, seed, *index):
    """The ``W0``, ``H0`` that the solve named by ``index`` hands ``nnmf``:
    ``draw_start``'s, or (None, None) where the traffic names ``nnmf``'s
    own ``init`` (default ``"custom"``)."""
    if traffic.get("init", "custom") != "custom":
        return None, None
    return draw_start(shape, k, device, seed, *index)


def nnmf_seed(seed, *index) -> int:
    """The ``seed`` that the solve named by ``index`` hands ``nnmf``."""
    return mix(seed, "nnmf", *index)


class Solver:
    """The cell's solve through the program's front door; on a ``mesh``
    (``device`` its lead) for a cell cut over one."""

    def __init__(self, nt, X, k, traffic, device, xsq, mesh=None):
        self.nt, self.X, self.k, self.tr, self.device, self.xsq = nt, X, k, traffic, device, xsq
        self.mesh = mesh

    def __call__(self, W0, H0, seed, warm=False) -> Answer:
        """The solve from ``W0``, ``H0``, or, where the traffic names
        ``nnmf``'s own ``init``, from that init (``W0``, ``H0`` unused);
        a solve to a target continues from where each call stopped."""
        tr = self.tr
        init = tr.get("init", "custom")
        start = dict(init="custom", W0=W0, H0=H0) if init == "custom" else dict(init=init)
        kw = dict(alg=tr["alg"], tol=tr["tol"], device=self.device,
                  mesh=self.mesh, seed=seed,
                  replicates=tr.get("replicates", 1),
                  parallel_replicates=tr.get("parallel_replicates", False))
        if tr["kind"] == "iterations":
            res = self.nt.nnmf(self.X, self.k, maxiter=2 if warm else tr["maxiter"],
                               **start, **kw)
            return Answer(res.W, res.H, res.niters)
        iters, calls = 0, 0
        while True:
            res = self.nt.nnmf(self.X, self.k, maxiter=tr["chunk"], **start, **kw)
            W, H = res.W, res.H
            start = dict(init="custom", W0=W, H0=H)
            iters += res.niters
            calls += 1
            with self.nt.config.precision_scope():
                mse = float(self.nt.mse_objective(self.X, W, H))
            rel = math.sqrt(max(2 * mse, 0.0) / self.xsq)
            if warm or rel <= tr["target_relerr"] or iters >= tr["cap"]:
                return Answer(W, H, iters, calls, rel)


def prepare_operand(cell, data, device, spans):
    """The program's X: a store built from the entries on the host, as a
    user builds it once a matrix, or the dense tensor itself."""
    if data["kind"] == "dense":
        X = data["X"]
        return X, sum(float((X[i:i + 8192].double() ** 2).sum())
                      for i in range(0, X.shape[0], 8192)), None
    from nmf_tpu_torch.ops.sparse_format import build_tiled

    rows, cols, vals = (data[a].cpu().numpy() for a in ("rows", "cols", "vals"))
    nnz = len(vals)
    xsq = float((data["vals"].double() ** 2).sum())
    data.clear()  # the benchmark's copy leaves the device
    t = time.perf_counter()
    X = build_tiled(rows, cols, vals, (cell.config["rows"], cell.config["cols"]),
                    device=device, **cell.config.get("store", {}))
    sync(device)
    spans["store_build_s"] = time.perf_counter() - t
    return X, xsq, nnz


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run; returns the result line (as a dict) and the checks."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    import nmf_tpu_torch as nt

    spans = {}
    if device.type == "cuda":
        from nmf_tpu_torch.ops.cuda import build

        t = time.perf_counter()
        build.load_kernels()
        spans["kernels_load_s"] = time.perf_counter() - t
    gen = cell.module("generators", cell.config["generator"])
    t = time.perf_counter()
    data = gen.make(cell.config, seed, device)
    sync(device)
    spans["data_s"] = time.perf_counter() - t
    shape = data["shape"]
    X, xsq, nnz = prepare_operand(cell, data, device, spans)
    del data
    k = cell.config["rank"]
    solve = Solver(nt, X, k, cell.traffic, device, xsq)

    t = time.perf_counter()
    W0, H0 = solve_start(cell.traffic, shape, k, device, seed, "warmup")
    solve(W0, H0, nnmf_seed(seed, "warmup"), warm=True)
    del W0, H0
    sync(device)
    spans["warmup_s"] = time.perf_counter() - t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(cell, device, nt, X, shape, nnz, k, spans=spans)
    ctx.setup_s = time.perf_counter() - t_start

    # the window
    pick = random.Random(mix(seed, "sample"))
    kept = None  # (index, Answer on the host)
    failed = attempted = 0
    ans = None
    end = time.perf_counter() + seconds
    while True:
        ans = None
        W0, H0 = solve_start(cell.traffic, shape, k, device, seed, attempted)
        sync(device)
        attempted += 1
        t = time.perf_counter()
        try:
            ans = solve(W0, H0, nnmf_seed(seed, attempted - 1))
            sync(device)
        except Exception:  # the window reports a solve that raises, and stops
            traceback.print_exc(file=sys.stderr)
            failed += 1
            break
        dt = time.perf_counter() - t
        del W0, H0
        ctx.solves.append((dt, Answer(None, None, ans.niters, ans.calls, ans.relerr)))
        if ans.relerr is not None and not ans.relerr <= cell.traffic["target_relerr"]:
            failed += 1  # the answer never reached its target
        if pick.random() * len(ctx.solves) < 1:
            kept = (attempted - 1, Answer(ans.W.cpu(), ans.H.cpu(), ans.niters, ans.calls,
                                          ans.relerr))
        if time.perf_counter() >= end:
            break
    if device.type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated(device)
    ctx.last = ans

    if trace and ans is not None:
        from portbench.profile import profile_solve

        W0, H0 = solve_start(cell.traffic, shape, k, device, seed, "traced")
        sync(device)

        def one():
            solve(W0, H0, nnmf_seed(seed, "traced"))
            sync(device)

        ctx.trace = profile_solve(one)
        del W0, H0

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    if ctx.solves:
        for name in names:
            value = cell.module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = value

    # the program's state goes before the reference runs
    ctx.X = ctx.last = solve = X = ans = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.check import check, passes

    checks = check(cell, seed, kept, device) if kept is not None else {}
    correct = failed == 0 and kept is not None and passes(checks)
    spans["window_solves_s"] = [t for t, _ in ctx.solves]
    spans["window_solves_iters"] = [a.niters for _, a in ctx.solves]
    return {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
            "trace": ctx.trace, "peak_bytes": ctx.peak_bytes, "spans": spans, "checks": checks}
