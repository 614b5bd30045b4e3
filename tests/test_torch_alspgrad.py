"""ALS projected gradient of the PyTorch build against the JAX package's:
the flat subsolver, the per-factor solvers, the verbose table and the outer
solver, the same numpy inputs (from a seed) through both, on the CPU.

Tolerances: the inner iteration counts ``t`` are equal.  Values in float64
within ``rtol=1e-12`` and in float32 within ``rtol=1e-5`` (the JAX package's
own bound between its flat and its nested form: the same math, reductions
summed in another order); the outer solver on dense float64 X within
``rtol=1e-9``; on the tiled store (float32 products summed in another order
on each side, fed through two sweeps of inner solves) ``rtol=1e-3,
atol=1e-4`` on the factors and ``rtol=1e-4`` on the objective."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models.alspgrad import _pg_subsolve as jax_subsolve
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch.models import alspgrad
from nmf_tpu_torch.ops.sparse_format import build_tiled

from testproblems import laurberg6x3
from torch_parity import BUILD, coo_of, three_class_matrix

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
_jax_subsolve = jax.jit(jax_subsolve, static_argnums=(3, 4))


def _grams(seed, dtype, k=5, m=17):
    rng = np.random.default_rng(seed)
    A = rng.random((12, k)).astype(dtype)
    return (A.T @ A, (A.T @ rng.random((12, m))).astype(dtype),
            rng.random((k, m)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pg_subsolve_matches_jax(dtype, seed):
    """The same Y and the same number of PG iterations as the JAX package's
    flat subsolver (compiled, as its solves run it)."""
    AtA, AtB, Y0 = _grams(seed, dtype)
    args = (50, 20, dtype(1e-8), dtype(0.2), dtype(0.01))
    Yj, tj = _jax_subsolve(jnp.asarray(AtA), jnp.asarray(AtB), jnp.asarray(Y0), *args)
    Yt, tt = alspgrad._pg_subsolve(*map(torch.from_numpy, (AtA, AtB, Y0)), *args)
    assert tt == int(tj) and tt > 1
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["h", "w"])
def test_per_factor_solvers_match_jax(dtype, which):
    rng = np.random.default_rng(31)
    X, Wg, Hg = laurberg6x3(dtype(0.3), dtype)
    kw = dict(maxiter=200, tolg=1e-5)
    if which == "h":
        args = (X, Wg, rng.random(Hg.shape).astype(dtype))
        fj, ft, out = nmf_tpu.alspgrad_updateh, nt.alspgrad_updateh, Hg
    else:
        args = (X, rng.random(Wg.shape).astype(dtype), Hg)
        fj, ft, out = nmf_tpu.alspgrad_updatew, nt.alspgrad_updatew, Wg
    Yj, tj = fj(*map(jnp.asarray, args), **kw)
    Yt, tt = ft(*map(torch.from_numpy, args), device="cpu", **kw)
    assert tt == tj
    np.testing.assert_allclose(Yt.numpy(), np.asarray(Yj), rtol=RTOL[dtype],
                               atol=10 * np.finfo(dtype).eps)
    assert (Yt >= 0).all() and np.allclose(Yt.numpy(), out, atol=np.finfo(dtype).eps ** 0.25)


@pytest.mark.parametrize("which", ["h", "w"])
def test_verbose_table_against_the_flat_loop(which, capsys):
    rng = np.random.default_rng(32)
    X, Wg, Hg = laurberg6x3(0.3)
    f = nt.alspgrad_updateh if which == "h" else nt.alspgrad_updatew
    args = (X, Wg, rng.random(Hg.shape)) if which == "h" else (X, rng.random(Wg.shape), Hg)
    args = [torch.from_numpy(a) for a in args]
    Yq, tq = f(*args, maxiter=100, tolg=1e-6, device="cpu")
    Yv, tv = f(*args, maxiter=100, tolg=1e-6, verbose=True, device="cpu")
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == ["Iter", "objv", "objv.change", "1st-ord", "alpha",
                                "back-tracks"]
    assert len(table) == tv + 2 and tv == tq
    np.testing.assert_allclose(Yv.numpy(), Yq.numpy(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("iters", [1, 4])
def test_alspgrad_sweeps_on_dense_x_match_jax(iters):
    rng = np.random.default_rng(0)
    X = rng.random((40, 4)) @ rng.random((4, 30)) + 0.01 * rng.random((40, 30))
    W0, H0 = rng.random((40, 4)), rng.random((4, 30))
    opts = dict(maxiter=iters, maxsubiter=30, tol=1e-30)
    rj = nmf_tpu.solve(nmf_tpu.ALSPGrad(**opts), *map(jnp.asarray, (X, W0, H0)))
    rt = nt.solve(nt.ALSPGrad(**opts), *map(torch.from_numpy, (X, W0, H0)), device="cpu")
    assert rt.niters == rj.niters
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-9)


def test_alspgrad_on_the_tiled_store_matches_jax():
    Xd = three_class_matrix(2)
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(4)
    k = 5
    W0 = rng.random((Xd.shape[0], k), dtype=np.float32)
    H0 = rng.random((k, Xd.shape[1]), dtype=np.float32)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    opts = dict(maxiter=2, maxsubiter=10, tol=1e-30)
    rj = nmf_tpu.solve(nmf_tpu.ALSPGrad(**opts), Xj, jnp.asarray(W0), jnp.asarray(H0))
    rt = nt.solve(nt.ALSPGrad(**opts), Xt, torch.from_numpy(W0), torch.from_numpy(H0),
                  device="cpu")
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-4)


def test_nnmf_alspgrad_matches_jax():
    rng = np.random.default_rng(9)
    X = rng.random((20, 3)) @ rng.random((3, 15))
    U, s, Vt = np.linalg.svd(X, full_matrices=False)
    kw = dict(alg="alspgrad", init="nndsvd", initdata=(U[:, :3], s[:3], Vt[:3].T),
              maxiter=5, tol=1e-30)
    rj = nmf_tpu.nnmf(jnp.asarray(X), 3, **kw)
    rt = nt.nnmf(torch.from_numpy(X), 3, device="cpu", **kw)
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-9)
