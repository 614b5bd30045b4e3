"""Sparse NMF with the PyTorch/CUDA build (the port of ``sparse_nmf.py``):
a sparse user-item matrix as a torch sparse tensor (the general-CSR path)
and as the tiled store whose products run the hand-written kernels.

Usage: python examples/torch_sparse_nmf.py [--device cuda|cpu] [--p P --n N]
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nmf_tpu_torch as nt  # noqa: E402
from nmf_tpu_torch.ops.sparse_format import build_tiled  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--p", type=int, default=2000)
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--k", type=int, default=16)
    a = ap.parse_args()

    rng = np.random.default_rng(0)
    p, n, k = a.p, a.n, a.k
    dense = ((rng.random((p, k)) @ rng.random((k, n))) * (rng.random((p, n)) < 0.05)
             ).astype(np.float32)
    r, c = np.nonzero(dense)

    # a torch sparse tensor of any layout: the general-CSR path
    X = torch.sparse_coo_tensor(np.stack([r, c]), dense[r, c], (p, n)).coalesce()
    ret = nt.nnmf(X, k, alg="cd", init="random", maxiter=50, device=a.device)
    print(f"torch sparse cd: niters={ret.niters} objv={ret.objvalue:.5e}")

    # the tiled store (kernels 1-3 and the band on the card)
    Xt = build_tiled(r, c, dense[r, c], (p, n), device=a.device)
    ret2 = nt.nnmf(Xt, k, alg="cd", init="random", maxiter=50, device=a.device)
    print(f"TiledCSR     cd: niters={ret2.niters} objv={ret2.objvalue:.5e}")

    ret3 = nt.nnmf(Xt, k, alg="multdiv", init="random", maxiter=25, device=a.device)
    print(f"TiledCSR multdiv (sampled product): objv={ret3.objvalue:.5e}")


if __name__ == "__main__":
    main()
