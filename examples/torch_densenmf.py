"""Dense NMF with the PyTorch/CUDA build (the port of ``densenmf.py``).

Usage: python examples/torch_densenmf.py [alg] [--device cuda|cpu]
with alg in: multmse multdiv projals alspgrad cd greedycd (default multmse).

Generates an 8 x 100 noisy rank-5 matrix, runs ``nnmf`` from the NNDSVD-ar
start with the iteration trace printed, and prints the factors and metrics.
The solve runs on the card unless ``--device cpu`` is given.
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nmf_tpu_torch as nt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("alg", nargs="?", default="multmse")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    rng = np.random.default_rng(5678)
    p, n, k = 8, 100, 5
    Wg = rng.random((p, k)) * 2.0
    Hg = rng.random((k, n))
    X = torch.from_numpy(np.maximum(Wg @ Hg + rng.standard_normal((p, n)) * 0.1, 0.0)
                         .astype(np.float32))

    ret = nt.nnmf(X, k, alg=a.alg, init="nndsvdar", maxiter=100, verbose=True,
                  device=a.device)

    X = X.to(ret.W.device)
    print(f"\nniters     = {ret.niters}")
    print(f"converged  = {ret.converged}")
    print(f"objvalue   = {ret.objvalue:.6e}")
    rel = float(torch.linalg.norm(X - ret.W @ ret.H) / torch.linalg.norm(X))
    print(f"rel. error = {rel:.4f}")
    print("\nW =")
    nt.printf_mat(ret.W)


if __name__ == "__main__":
    main()
