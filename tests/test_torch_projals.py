"""Projected ALS of the PyTorch build against the JAX package's: the same
numpy inputs (from a seed) through both, on the CPU.

Tolerances: dense X in float64, ``rtol=1e-9`` on the factors and the
objective — both packages solve the same k x k Cholesky systems, whose
float64 rounding differs by summation order only.  On the tiled store (float32
products), ``rtol=2e-4, atol=1e-5`` on the factors and ``rtol=1e-4`` on the
objective: the products sum in another order on each side, and each sweep
feeds that difference through two Cholesky solves."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch.ops.sparse_format import build_tiled

from testproblems import laurberg6x3
from torch_parity import BUILD, coo_of, three_class_matrix

F64 = dict(rtol=1e-9, atol=1e-12)
F32_STORE = dict(rtol=2e-4, atol=1e-5)


def _dense_problem(seed=0, p=40, n=30, k=4):
    rng = np.random.default_rng(seed)
    X = rng.random((p, k)) @ rng.random((k, n)) + 0.01 * rng.random((p, n))
    return X, rng.random((p, k)), rng.random((k, n))


def _same(rt, rj, tol, obj_rtol):
    assert rt.niters == rj.niters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), **tol)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), **tol)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=obj_rtol)


@pytest.mark.parametrize("iters", [1, 6])
def test_projals_sweeps_on_dense_x_match_jax(iters):
    X, W0, H0 = _dense_problem()
    opts = dict(maxiter=iters, tol=1e-30)
    rj = nmf_tpu.solve(nmf_tpu.ProjectedALS(**opts), *map(jnp.asarray, (X, W0, H0)))
    rt = nt.solve(nt.ProjectedALS(**opts), *map(torch.from_numpy, (X, W0, H0)),
                  device="cpu")
    _same(rt, rj, F64, 1e-9)


def test_projals_on_the_tiled_store_matches_jax():
    Xd = three_class_matrix(1)
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(3)
    k = 5
    W0 = rng.random((Xd.shape[0], k), dtype=np.float32)
    H0 = rng.random((k, Xd.shape[1]), dtype=np.float32)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    opts = dict(maxiter=3, tol=1e-30)
    rj = nmf_tpu.solve(nmf_tpu.ProjectedALS(**opts), Xj, jnp.asarray(W0), jnp.asarray(H0))
    rt = nt.solve(nt.ProjectedALS(**opts), Xt, torch.from_numpy(W0),
                  torch.from_numpy(H0), device="cpu")
    _same(rt, rj, F32_STORE, 1e-4)


def test_projals_recovery_and_regularized_objective():
    """The JAX package's recovery and penalty checks, on the port."""
    rng = np.random.default_rng(61)
    X, Wg, Hg = laurberg6x3(0.3)
    W = Wg + rng.random(Wg.shape) * 0.1
    res = nt.solve(nt.ProjectedALS(maxiter=1000, tol=1e-9), torch.from_numpy(X),
                   torch.from_numpy(W), torch.zeros(Hg.shape, dtype=torch.float64),
                   device="cpu")
    assert (res.W >= 0).all() and (res.H >= 0).all()
    assert np.allclose(X, (res.W @ res.H).numpy(), atol=1e-2)
    args = [torch.from_numpy(a) for a in (X, Wg, Hg)]
    r0 = nt.solve(nt.ProjectedALS(maxiter=10, lambda_w=0.0, lambda_h=0.0), *args,
                  device="cpu")
    r1 = nt.solve(nt.ProjectedALS(maxiter=10, lambda_w=1.0, lambda_h=1.0), *args,
                  device="cpu")
    assert r1.objvalue > r0.objvalue


def test_nnmf_projals_from_nndsvd_matches_jax():
    """``nnmf(alg="projals")`` hands the init ``zeroh=True``: H starts at
    zeros, as in the JAX package (the singular triplets come as ``initdata``,
    so neither package draws a number)."""
    X, _, _ = _dense_problem(seed=4)
    k = 3
    U, s, Vt = np.linalg.svd(X, full_matrices=False)
    data = (U[:, :k], s[:k], Vt[:k].T)
    kw = dict(alg="projals", init="nndsvd", initdata=data, maxiter=8, tol=1e-30)
    rj = nmf_tpu.nnmf(jnp.asarray(X), k, **kw)
    rt = nt.nnmf(torch.from_numpy(X), k, device="cpu", **kw)
    _same(rt, rj, F64, 1e-9)

    from nmf_tpu_torch.models import interface

    seen = []
    real = interface.solve_replicates

    def spy(alginst, X, W, H, **kw):
        seen.append((H.clone(), kw["initH"]))
        return real(alginst, X, W, H, **kw)

    interface.solve_replicates = spy
    try:
        nt.nnmf(torch.from_numpy(X), k, device="cpu", **kw)
    finally:
        interface.solve_replicates = real
    H, initH = seen[0]
    assert initH is False and not H.any()
