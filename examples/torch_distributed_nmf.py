"""NMF over a mesh that spans several processes, with the PyTorch/CUDA
build (the port of ``distributed_nmf.py``).

    python examples/torch_distributed_nmf.py                 # two CPU processes
    python examples/torch_distributed_nmf.py --device cuda   # one process a card

With ``--device cpu`` (the default) two processes join over gloo, each
owning four CPU cells of a (2, 4) mesh; with ``--device cuda`` one process
a visible card joins over NCCL, each owning one cell.  Every process
builds the same dense problem from the seed and keeps only its own blocks
of X; a sparse matrix is built from each process's own entries
(``shard_tiled(..., local=True)``).  W and H are whole on every process,
and every process returns the same Result.
"""

import argparse
import pathlib
import socket
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def worker(a):
    import torch

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.sparse_format import TILE
    from nmf_tpu_torch.parallel.mesh import init_distributed

    cpu = a.device == "cpu"
    if not cpu:
        torch.cuda.set_device(a.rank)
    init_distributed(f"localhost:{a.port}", a.world, a.rank,
                     backend="gloo" if cpu else "nccl", timeout=120)
    devices = ["cpu"] * 4 if cpu else [f"cuda:{a.rank}"]
    mesh = nt.make_mesh((2, 4) if cpu else None, devices=devices)
    rng = np.random.default_rng(0)
    p, n, k = a.p, a.n, 8
    X = (rng.random((p, k)) @ rng.random((k, n))).astype(np.float32)

    # dense: every process passes X whole and keeps its own blocks
    ret = nt.nnmf(X, k, alg="cd", init="nndsvdar", maxiter=50, mesh=mesh,
                  device=mesh.lead)
    print(f"rank {a.rank} dense   cd: niters={ret.niters} objv={ret.objvalue:.5e}")

    # sparse: each process passes only the entries of its own blocks
    S = X * (rng.random((p, n)) < 0.05)
    r, c = np.nonzero(S)
    R, C = mesh.ranks.shape
    local_p = -(-(-(-p // R)) // TILE) * TILE
    local_n = -(-(-(-n // C)) // TILE) * TILE
    mine = (mesh.ranks == mesh.rank)[r // local_p, c // local_n]
    Xs = nt.shard_tiled(r[mine], c[mine], S[r[mine], c[mine]], (p, n), mesh,
                        stripe_tiles=1, local=True)
    ret2 = nt.nnmf(Xs, k, alg="multdiv", init="random", maxiter=25, mesh=mesh,
                   device=mesh.lead)
    print(f"rank {a.rank} sparse  multdiv: niters={ret2.niters} "
          f"objv={ret2.objvalue:.5e} ({int(mine.sum())} of {len(r)} entries here)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--p", type=int, default=1024)
    ap.add_argument("--n", type=int, default=768)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    a = ap.parse_args()
    if a.rank is not None:
        return worker(a)
    if a.device == "cpu":
        world = 2
    else:
        import torch

        world = torch.cuda.device_count()
    if world < 1:
        raise RuntimeError("--device cuda found no CUDA device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--device", a.device, "--p", str(a.p), "--n", str(a.n),
         "--rank", str(r), "--world", str(world), "--port", str(port)])
        for r in range(world)]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        raise SystemExit(f"a process failed: exit codes {codes}")


if __name__ == "__main__":
    main()
