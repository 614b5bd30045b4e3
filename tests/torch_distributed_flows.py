"""The three flows of ``tests/test_multihost.py`` for the PyTorch build, on a
(2, 4) mesh of CPU cells, as functions of the mesh: the test process runs
them on a mesh of one process, and ``python tests/torch_distributed_flows.py
RANK PORT OUT CKDIR`` runs them as one of two gloo processes, four cells
each, and writes what they return to ``OUT/rank{RANK}.npz`` (a flow that
raised leaves its traceback under ``{flow}/error``).  Imports no JAX."""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch.models.checkpoint import (
    agreed_checkpoint,
    latest_checkpoint,
    solve_checkpointed,
)
from nmf_tpu_torch.ops.dense_shard import shard_dense
from nmf_tpu_torch.ops.sparse_format import TILE
from nmf_tpu_torch.ops.sparse_shard import shard_tiled, sharded_load_stats, sharded_mm
from nmf_tpu_torch.parallel.mesh import init_distributed, make_mesh

SHAPE = (2, 4)
CELLS_EACH = 4  # cells a process owns on two processes
# torch's CPU products may sum in another order with another number of
# threads: every process that runs a flow runs it with this many
THREADS = 2


def _result(res, prefix=""):
    return {f"{prefix}W": res.W.numpy(), f"{prefix}H": res.H.numpy(),
            f"{prefix}niters": np.asarray(res.niters),
            f"{prefix}objvalue": np.asarray(res.objvalue)}


def dense_problem(p, n, k):
    rng = np.random.default_rng(0)
    return (rng.random((p, n)).astype(np.float32), rng.random((p, k)).astype(np.float32),
            rng.random((k, n)).astype(np.float32))


def dense_solve(mesh):
    """``test_multihost.py:66``: MultUpdate (mse), 10 iterations, 64 x 64,
    k 4, X cut over the mesh."""
    X, W, H = dense_problem(64, 64, 4)
    Xm = shard_dense(torch.from_numpy(X), mesh)
    res = nt.solve(nt.MultUpdate(obj="mse", maxiter=10, tol=1e-30), Xm,
                   torch.from_numpy(W), torch.from_numpy(H), device="cpu")
    return _result(res)


def sparse_problem():
    """``test_multihost.py:197``'s matrix, product operand and factors, drawn
    in its order from one stream."""
    rng = np.random.default_rng(0)
    p, n, k = 300, 260, 5
    Xd = (rng.random((p, n)) * (rng.random((p, n)) < 0.07)).astype(np.float32)
    D = rng.random((n, 8)).astype(np.float32)
    W0 = rng.random((p, k)).astype(np.float32)
    H0 = rng.random((k, n)).astype(np.float32)
    return Xd, D, W0, H0


def own_entries(mesh, r, c, shape):
    """Which of the entries ``(r, c)`` fall in this process's blocks."""
    R, C = mesh.ranks.shape
    local_p = -(-(-(-shape[0] // R)) // TILE) * TILE
    local_n = -(-(-(-shape[1] // C)) // TILE) * TILE
    return (mesh.ranks == mesh.rank)[r // local_p, c // local_n]


def local_store(mesh):
    """``test_multihost.py:197``: each process builds its own blocks from its
    own entries (``local=True``, ``stripe_tiles=1``), its share of the
    slots, a product, MultUpdate (div) for 3 iterations, the load table,
    and ``nnmf`` from its NNDSVD-ar and its random start."""
    Xd, D, W0, H0 = sparse_problem()
    r, c = np.nonzero(Xd)
    v = Xd[r, c]
    m = own_entries(mesh, r, c, Xd.shape)
    X = shard_tiled(r[m], c[m], v[m], Xd.shape, mesh, stripe_tiles=1, local=True)
    st = sharded_load_stats(X)
    own = mesh.ranks == mesh.rank
    res = nt.solve(nt.MultUpdate(obj="div", maxiter=3), X, torch.from_numpy(W0),
                   torch.from_numpy(H0), device="cpu")
    return {"mm": sharded_mm(X, torch.from_numpy(D)).numpy(),
            "slot_share": np.asarray(st["slots"][own].sum() / st["slots"].sum()),
            "nnz_local": np.asarray(int(m.sum())), "nnz_total": np.asarray(len(v)),
            "total_nnz": st["total_nnz"], "slots": st["slots"],
            "stats": X.stats.numpy(), **_result(res),
            # the seeded starts on every process: NNDSVD-ar and a random one
            **_result(nt.nnmf(X, 5, maxiter=3, mesh=mesh, device="cpu"), "nndsvdar_"),
            **_result(nt.nnmf(X, 5, alg="cd", init="random", maxiter=3, mesh=mesh,
                              device="cpu"), "random_")}


def checkpoint_resume(mesh, ckdir):
    """``test_multihost.py:334``: a checkpointed MultUpdate (mse) solve,
    snapshots every 5 to 10, process 0's step-10 file lost, the processes
    agreeing on step 5 and resuming to 20."""
    X, W, H = dense_problem(64, 48, 4)
    Xm = shard_dense(torch.from_numpy(X), mesh)
    W, H = torch.from_numpy(W), torch.from_numpy(H)
    alg = nt.MultUpdate(obj="mse", maxiter=20, tol=1e-12)
    plain = nt.solve(alg, Xm, W, H, device="cpu")
    solve_checkpointed(nt.MultUpdate(obj="mse", maxiter=10, tol=1e-12), Xm, W, H,
                       checkpoint_dir=ckdir, checkpoint_every=5, device="cpu")
    first = latest_checkpoint(ckdir)[1]
    if mesh.rank == 0:
        os.remove(os.path.join(ckdir, "ckpt_10.proc0.npz"))
    agreed = agreed_checkpoint(ckdir)[1]
    res = solve_checkpointed(alg, Xm, W, H, checkpoint_dir=ckdir, checkpoint_every=5,
                             device="cpu")
    return {"first_latest": np.asarray(first), "agreed": np.asarray(agreed),
            "last_latest": np.asarray(latest_checkpoint(ckdir)[1]),
            **_result(res), **_result(plain, "plain_")}


def errors(mesh):
    """What must raise across processes: an entry in another process's
    block (given to process 0 only: every process raises), a grid that does
    not split evenly among the processes."""
    Xd, *_ = sparse_problem()
    r, c = np.nonzero(Xd)
    m = own_entries(mesh, r, c, Xd.shape)
    if mesh.rank == 0:
        m[np.flatnonzero(~m)[0]] = True
    out = {}
    try:
        shard_tiled(r[m], c[m], Xd[r[m], c[m]], Xd.shape, mesh, local=True)
        out["foreign_entry"] = np.asarray("no error")
    except ValueError as e:
        out["foreign_entry"] = np.asarray(str(e))
    try:
        make_mesh((1, 3), devices=["cpu"])
        out["uneven_grid"] = np.asarray("no error")
    except ValueError as e:
        out["uneven_grid"] = np.asarray(str(e))
    return out


def main():
    rank, port, out, ckdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch.distributed as dist

    torch.set_num_threads(THREADS)
    init_distributed(f"localhost:{port}", 2, rank, backend="gloo", timeout=60)
    group = dist.group.WORLD
    init_distributed(f"localhost:{port}", 2, rank, backend="gloo", timeout=60)
    results = {"second_init_kept_the_group": np.asarray(
        dist.group.WORLD is group and dist.get_world_size() == 2)}
    mesh = make_mesh(SHAPE, devices=["cpu"] * CELLS_EACH)
    for name, fn in (("dense_solve", lambda: dense_solve(mesh)),
                     ("local_store", lambda: local_store(mesh)),
                     ("checkpoint_resume", lambda: checkpoint_resume(mesh, ckdir)),
                     ("errors", lambda: errors(mesh))):
        try:
            results.update({f"{name}/{k}": v for k, v in fn().items()})
        except Exception:  # recorded for the test to report; the next flow runs
            results[f"{name}/error"] = np.asarray(traceback.format_exc())
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
