"""A cell whose configuration has a ``mesh``: one process a card.

``run.py`` hands such a cell to ``launch``, which starts ``chips``
processes of this file on this host, rank r on card r, and waits for them.
Each joins the others over NCCL (``nmf_tpu_torch.parallel.mesh
.init_distributed``, from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``), builds the mesh (``make_mesh``) and runs ``run_ranks``:

- set-up: every rank draws the whole matrix from the seed on its own card
  and keeps the entries of its own blocks (the generator's ``blocks``),
  from which it builds its part of the sharded store
  (``shard_tiled(..., local=True)``); W0 and H0 are drawn whole, from the
  same seed, on every rank; the solve goes through ``nnmf(mesh=mesh,
  device=mesh.lead)``;
- the window: every rank starts each solve after a barrier and ends it with
  a synchronize; rank 0 decides on its own clock whether the window goes on
  and tells the others, so every rank runs the same solves.  ``solve_s`` is
  rank 0's clock;
- ``--trace 1``: every rank profiles the traced solve at once, since its
  collectives need them all;
- each rank's numbers (its solves, peak memory, store build, trace) are
  gathered to rank 0: ``peak_gb`` and ``store_build_s`` are the largest,
  ``idle_pct``, ``launches_per_solve`` and the breakdown rank 0's, each
  rank's own on standard error (``ranks`` in the set-up parts);
- the check: every rank frees its state and leaves the group; rank 0 alone
  draws the whole matrix again and holds the answer it kept (every process
  holds W and H whole) against the plain reference, as ``check.py`` does.

A rank that raises, or finds a JAX module loaded (exit 4), exits non-zero,
and ``launch`` ends the others at once: the run prints no result.  The
group's timeout bounds every collective besides, and a rank dies with its
launcher.  Only rank 0 prints the result line, after every rank has ended;
the others' standard error comes first, each line marked with its rank.

A mesh of one process (``make_mesh(shape, devices=[device] * cells)``)
runs the same code with no exchange: the tests' CPU runs, and
``readings.py``'s one-card readings (``read_seed``).
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import manifest, nojax  # noqa: E402
from portbench.common import mix, sync  # noqa: E402
from portbench.harness import Answer, Context, Solver, draw_start, nnmf_seed  # noqa: E402

GROUP_TIMEOUT_S = 300.0  # every collective: longer than the slowest rank's store build
T_START = "PORTBENCH_T_START"  # the launcher's start, on the host's monotonic clock
PARENT = "PORTBENCH_PARENT"
POLL_S = 0.2


# ---------------------------------------------------------------- launcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _drain(stream, sink, prefix, lock):
    for line in stream:
        if sink is not None:
            sink.append(line)
        else:
            with lock:
                sys.stderr.write(prefix + line)
                sys.stderr.flush()


def launch(workload: str, seed: int, seconds: float, trace: int, chips: int,
           backend: str = "nccl", script=None, t_start: float | None = None) -> int:
    """The run as ``chips`` processes of ``script`` (this file), rank r on
    card r; returns the exit code.  Ranks 1.. have their standard output
    and error passed on to standard error as they come, each line marked
    ``[rank r]``; rank 0's standard error follows once every rank has
    ended, and then, where every rank exited with 0, its result line.  The
    first rank to fail ends the others."""
    port = free_port()
    t_start = time.perf_counter() if t_start is None else t_start
    cmd = [sys.executable, str(script or Path(__file__).resolve()), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--backend", backend]
    procs = [subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(chips),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **{
                     T_START: repr(t_start), PARENT: str(os.getpid())}))
        for r in range(chips)]
    lock = threading.Lock()
    out0, err0 = [], []
    threads = [threading.Thread(target=_drain, args=(stream, sink, f"[rank {r}] ", lock))
               for r, p in enumerate(procs)
               for stream, sink in ((p.stdout, out0 if r == 0 else None),
                                    (p.stderr, err0 if r == 0 else None))]
    for t in threads:
        t.start()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads:
            t.join()
    codes = [p.returncode for p in procs]
    sys.stderr.write("".join(err0))
    failed = [c for c in codes if c != 0]
    if failed:
        print(f"portbench: rank exit codes {codes}", file=sys.stderr)
        return failed[0] if failed[0] > 0 else 1
    found = nojax.loaded()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    sys.stdout.write("".join(out0))
    sys.stdout.flush()
    return 0


# ---------------------------------------------------------------- one rank


class Group:
    """The run's processes, as the mesh spans them: a barrier, rank 0's
    decision handed to all, every rank's object.  A mesh of one process
    needs none of it."""

    def __init__(self, mesh):
        self.rank, self.world = mesh.rank, mesh.processes
        self.device = mesh.lead

    def barrier(self):
        if self.world > 1:
            import torch.distributed as dist

            if self.device.type == "cuda":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.world == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def close(self):
        if self.world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def memory_peak(device) -> int:
    """``torch.cuda.max_memory_allocated`` of the card; 0 off a card."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def owned_blocks(config: dict, mesh) -> list:
    """The ``((r0, r1), (c0, c1))`` ranges of X's blocks that this process
    holds, as ``shard_tiled`` cuts X: ``ceil(rows / R)`` rows a block,
    rounded up to whole tiles, and the columns alike."""
    from nmf_tpu_torch.ops.sparse_format import TILE

    p, n = config["rows"], config["cols"]
    R, C = mesh.ranks.shape
    lp = -(-(-(-p // R)) // TILE) * TILE
    ln = -(-(-(-n // C)) // TILE) * TILE
    return [((i * lp, min((i + 1) * lp, p)), (j * ln, min((j + 1) * ln, n)))
            for i in range(R) for j in range(C) if mesh.ranks[i, j] == mesh.rank]


def whole(config: dict) -> list:
    return [((0, config["rows"]), (0, config["cols"]))]


def build_store(cell, data, mesh, spans):
    """This process's part of the sharded store from its own entries, and
    the sum of their squares (float64)."""
    from nmf_tpu_torch.ops.sparse_shard import shard_tiled

    rows, cols, vals = (data[a].cpu().numpy() for a in ("rows", "cols", "vals"))
    xsq = float((data["vals"].double() ** 2).sum())
    data.clear()  # the benchmark's copy leaves the device
    t = time.perf_counter()
    X = shard_tiled(rows, cols, vals, (cell.config["rows"], cell.config["cols"]), mesh,
                    local=True, **cell.config.get("store", {}))
    sync(mesh.lead)
    spans["store_build_s"] = time.perf_counter() - t
    return X, xsq


def _trace_numbers(tr) -> dict:
    if tr is None or not tr["device_events"] or tr["window_s"] <= 0:
        return {}
    return {"idle_pct": 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]),
            "launches": tr["launches"],
            "collective_pct": 100.0 * tr["collective_s"] / tr["busy_s"] if tr["busy_s"] else None}


def run_ranks(cell, seed: int, seconds: float, trace: bool, mesh,
              t_start: float | None = None) -> dict:
    """One rank of the run; rank 0 returns the result line (as a dict) and
    the checks, as ``harness.run_cell`` does, the others None."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = mesh.lead
    group = Group(mesh)
    import nmf_tpu_torch as nt

    spans = {}
    if device.type == "cuda":
        from nmf_tpu_torch.ops.cuda import build

        t = time.perf_counter()
        build.load_kernels()
        spans["kernels_load_s"] = time.perf_counter() - t
    gen = cell.module("generators", cell.config["generator"])
    t = time.perf_counter()
    data = gen.make(cell.config, seed, device, owned_blocks(cell.config, mesh))
    sync(device)
    spans["data_s"] = time.perf_counter() - t
    shape = data["shape"]
    X, xsq = build_store(cell, data, mesh, spans)
    del data
    xsq = sum(group.gather(xsq))
    k = cell.config["rank"]
    solve = Solver(nt, X, k, cell.traffic, device, xsq, mesh=mesh)

    t = time.perf_counter()
    W0, H0 = draw_start(shape, k, device, seed, "warmup")
    solve(W0, H0, nnmf_seed(seed, "warmup"), warm=True)
    del W0, H0
    sync(device)
    spans["warmup_s"] = time.perf_counter() - t
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(cell, device, nt, X, shape, X.nnz, k, spans=spans)
    group.barrier()
    ctx.setup_s = time.perf_counter() - t_start

    # the window: a solve that raises ends the run (see the module's note)
    pick = random.Random(mix(seed, "sample"))
    kept = None  # rank 0's (index, Answer on the host)
    attempted = 0
    end = time.perf_counter() + seconds
    while True:
        W0, H0 = draw_start(shape, k, device, seed, attempted)
        sync(device)
        attempted += 1
        group.barrier()
        t = time.perf_counter()
        ans = solve(W0, H0, nnmf_seed(seed, attempted - 1))
        sync(device)
        dt = time.perf_counter() - t
        del W0, H0
        ctx.solves.append((dt, Answer(None, None, ans.niters, ans.calls, ans.relerr)))
        if group.rank == 0 and pick.random() * len(ctx.solves) < 1:
            kept = (attempted - 1, Answer(ans.W.cpu(), ans.H.cpu(), ans.niters, ans.calls,
                                          ans.relerr))
        if not group.decide(time.perf_counter() < end):
            break
    spans["window_wall_s"] = time.perf_counter() - end + seconds
    peak = memory_peak(device)
    ctx.last = ans

    if trace:
        from portbench.profile import profile_solve

        W0, H0 = draw_start(shape, k, device, seed, "traced")
        sync(device)

        def one():
            solve(W0, H0, nnmf_seed(seed, "traced"))
            sync(device)

        group.barrier()
        t = time.perf_counter()
        ctx.trace = profile_solve(one)
        spans["trace_s"] = time.perf_counter() - t
        del W0, H0

    ranks = group.gather({
        "rank": group.rank, "solves_s": [t for t, _ in ctx.solves], "peak_bytes": peak,
        "store_build_s": spans["store_build_s"], "kernels_load_s": spans.get("kernels_load_s"),
        "data_s": spans["data_s"], "warmup_s": spans["warmup_s"], "trace": ctx.trace})
    if len({len(r["solves_s"]) for r in ranks}) != 1:
        raise RuntimeError(f"the ranks ran different solves: {[len(r['solves_s']) for r in ranks]}")
    ctx.peak_bytes = max(r["peak_bytes"] for r in ranks)
    spans["store_build_s"] = max(r["store_build_s"] for r in ranks)
    if device.type == "cuda":
        spans["kernels_load_s"] = max(r["kernels_load_s"] for r in ranks)
    if ctx.trace is not None:
        ctx.trace = dict(ctx.trace, ranks=[r["trace"] for r in ranks])

    metrics = {}
    if group.rank == 0:
        for name in cell.per_layer if trace else cell.end_to_end:
            value = cell.module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = value

    # the program's state goes before the reference runs
    ctx.X = ctx.last = solve = X = ans = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    group.close()
    if group.rank != 0:
        return None
    from portbench.check import check, passes

    checks = {}
    t = time.perf_counter()
    if kept is not None:
        checks = check(cell, seed, kept, device,
                       data=gen.make(cell.config, seed, device, whole(cell.config)))
    spans["check_s"] = time.perf_counter() - t
    spans["window_solves_s"] = [t for t, _ in ctx.solves]
    spans["window_solves_iters"] = [a.niters for _, a in ctx.solves]
    spans["ranks"] = [dict({key: r[key] for key in ("rank", "peak_bytes", "store_build_s",
                                                    "kernels_load_s", "data_s", "warmup_s")},
                           solves=len(r["solves_s"]),
                           solve_s=sum(r["solves_s"]) / len(r["solves_s"]),
                           **_trace_numbers(r["trace"])) for r in ranks]
    return {"correct": kept is not None and passes(checks), "attempted": attempted,
            "failed": 0, "metrics": metrics, "trace": ctx.trace, "peak_bytes": ctx.peak_bytes,
            "spans": spans, "checks": checks}


def _die_with_parent():
    """Ask the kernel to end this process when its launcher ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.environ.get(PARENT) and os.getppid() != int(os.environ[PARENT]):
        os._exit(1)  # the launcher ended before the call


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a cell cut over a mesh")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args(argv)
    _die_with_parent()
    t_start = float(os.environ.get(T_START) or time.perf_counter())
    rank = int(os.environ["RANK"])
    cell = manifest.load_cell(args.workload)
    if args.backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        torch.cuda.init()
    else:
        device = torch.device("cpu")
    started = time.perf_counter() - t_start
    from nmf_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(backend=args.backend, timeout=GROUP_TIMEOUT_S)
    mesh = make_mesh(tuple(cell.config["mesh"]), devices=[device])
    res = run_ranks(cell, args.seed, args.seconds, bool(args.trace), mesh, t_start)
    if rank == 0:
        from portbench import run

        return run.report(cell, res, device, started)
    found = nojax.loaded()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


# ---------------------------------------------------------------- readings


def read_seed(cell, seed: int, device, control: int, solves: int = 1,
              program: bool = True) -> list:
    """``readings.read_seed`` for a cell cut over a mesh, on one card: the
    program on a mesh of one process (every block on ``device``: the same
    steps on the same bits as one process a card), its answers kept on the
    host; once its state is freed, the reference and, on the first
    ``control`` solves, the control, from the same starts.  Without
    ``program`` the control alone: at the cell's own size its blocks do not
    fit one card together."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import make_mesh

    from portbench import check
    from portbench.reference import common as refc

    cfg = cell.config
    gen = cell.module("generators", cfg["generator"])
    t = time.perf_counter()
    data = gen.make(cfg, seed, device, whole(cfg))
    sync(device)
    out = {"cell": cell.name, "seed": seed, "data_s": time.perf_counter() - t}
    shape, k, iters = data["shape"], cfg["rank"], cell.traffic["maxiter"]
    kept = [(index, None, None) for index in range(solves)]
    if program:
        R, C = cfg["mesh"]
        X, xsq = build_store(cell, dict(data), make_mesh((R, C), devices=[device] * (R * C)),
                             out)
        solve = Solver(nt, X, k, cell.traffic, device, xsq, mesh=X.mesh)
        for index in range(solves):
            W0, H0 = draw_start(shape, k, device, seed, index)
            sync(device)
            t = time.perf_counter()
            ans = solve(W0, H0, nnmf_seed(seed, index))
            sync(device)
            out[f"program_s_{index}"] = time.perf_counter() - t
            kept[index] = (index, ans.W.cpu(), ans.H.cpu())
            del W0, H0, ans
        X = solve = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    Xref = refc.operand(data)
    lines = []
    for index, W, H in kept:
        line = dict(out, index=index)
        lanes = check.lane_starts(cell, shape, seed, index, device)
        t = time.perf_counter()
        exact = check.answers(cell, Xref, lanes, iters, low=False)
        line["reference_s"] = time.perf_counter() - t
        if W is not None:
            line["program"] = check.numbers(cell, Xref, W, H, exact)
        if index < control:
            t = time.perf_counter()
            Wc, Hc = check.answers(cell, Xref, lanes, iters, low=True)[0]
            line["control_s"] = time.perf_counter() - t
            line["control"] = check.numbers(cell, Xref, Wc, Hc, exact)
            del Wc, Hc
        del exact, lanes
        lines.append(line)
    return lines


if __name__ == "__main__":
    sys.exit(rank_main())
