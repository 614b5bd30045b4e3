"""Separable NMF via SPA with the PyTorch/CUDA build (the port of
``separable_nmf.py``): exactly separable data, factorized with
``alg="spa", init="spa"``.

Usage: python examples/torch_separable_nmf.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import nmf_tpu_torch as nt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    m, n, k = 100, 50, 5
    W, H = nt.separable_data(m, n, k, device=a.device)
    X = W @ H
    ret = nt.nnmf(X, k, alg="spa", init="spa", device=a.device)
    err = float(nt.sqL2dist(X, ret.W @ ret.H))
    print(f"niters={ret.niters} converged={ret.converged} objv={ret.objvalue:.3e}")
    print(f"sqL2dist(X, WH) = {err:.3e}")


if __name__ == "__main__":
    main()
