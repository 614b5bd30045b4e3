"""The dense X on a mesh of the PyTorch build (``ops/dense_shard.py``,
``nnmf(Xd, k, mesh=...)``) on the CPU: against the port's whole X, against
the JAX package's sharded solve on its (2, 4) mesh of virtual devices, and
block by block against float64 sums.

Meshes: ``make_mesh((2, 4), devices=["cpu"] * 8)``, the JAX tests' grid,
and (1, 1).  Every block takes the plain versions of kernels 6, 8 and 9.

Tolerances (float64):

* a (1, 1) mesh against the whole X: ``torch.equal`` (the one block is X,
  each product and objective the whole X's one call, the float64 sum of one
  value exact);
* a (2, 4) mesh against the whole X, and against the JAX package's sharded
  solve: ``rtol=1e-8``, as ``tests/test_sharding.py`` holds the JAX
  package's sharded solve against its replicated one (the partials of a row
  block, or a column block, are added in another order than one product
  sums them);
* the products of the blocks against the whole X's: ``rtol=1e-12``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nmf_tpu_torch.ops import dense_shard as ds
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops.cuda.mu import qht_plain, wtq_plain
from nmf_tpu_torch.ops.objectives import kl_objective, mse_objective

ALGS = ["multmse", "multdiv", "projals", "cd", "greedycd", "alspgrad"]
SHARDED = dict(rtol=1e-8, atol=1e-10)
BLOCKS = dict(rtol=1e-12, atol=1e-13)


def cpu_mesh(shape):
    return nt.make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def _problem(seed=111, p=32, n=48, k=4):
    """``tests/test_sharding.py``'s problem."""
    rng = np.random.default_rng(seed)
    Wg = np.maximum(rng.random((p, k)) - 0.2, 0)
    Hg = np.maximum(rng.random((k, n)) - 0.2, 0)
    X = Wg @ Hg + 0.01 * rng.random((p, n))
    return X, rng.random((p, k)), rng.random((k, n))


@pytest.mark.parametrize("alg", ALGS)
def test_sharded_equals_unsharded(alg):
    X, W0, H0 = _problem()
    # ALSPGrad's inner loops take a second an outer iteration here: 6 of them
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, device="cpu",
              maxiter=6 if alg == "alspgrad" else 12)
    ref = nt.nnmf(X, 4, **kw)
    shd = nt.nnmf(X, 4, mesh=cpu_mesh((2, 4)), **kw)
    assert (shd.niters, shd.converged) == (ref.niters, ref.converged)
    np.testing.assert_allclose(shd.W.numpy(), ref.W.numpy(), **SHARDED)
    np.testing.assert_allclose(shd.H.numpy(), ref.H.numpy(), **SHARDED)
    assert np.isclose(shd.objvalue, ref.objvalue, rtol=1e-8)
    assert nt.nnmf(X, 4, mesh=cpu_mesh((1, 1)), **kw) == ref


@pytest.mark.parametrize("alg", ["multdiv", "cd"])
def test_sharded_against_the_jax_package(alg):
    X, W0, H0 = _problem(seed=112)
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=12)
    want = nmf_tpu.nnmf(jnp.asarray(X), 4, mesh=jax_make_mesh((2, 4)), **kw)
    got = nt.nnmf(X, 4, mesh=cpu_mesh((2, 4)), device="cpu", **kw)
    assert got.niters == want.niters
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **SHARDED)
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), **SHARDED)
    assert np.isclose(got.objvalue, float(want.objvalue), rtol=1e-8)


def test_replicates_and_update_H_on_a_mesh():
    """``tests/test_sharding.py:97``: replicates on a mesh (one after the
    other and as one batch), and ``update_H=False`` keeps H."""
    rng = np.random.default_rng(115)
    p, n, k = 32, 32, 4
    X = np.abs(rng.random((p, n)))
    mesh = cpu_mesh((2, 4))
    kw = dict(alg="multmse", init="random", replicates=3, maxiter=8, seed=2,
              device="cpu")
    seq = nt.nnmf(X, k, mesh=mesh, **kw)
    par = nt.nnmf(X, k, mesh=mesh, parallel_replicates=True, **kw)
    assert np.isfinite(seq.objvalue) and par == seq
    whole = nt.nnmf(X, k, **kw)
    np.testing.assert_allclose(seq.W.numpy(), whole.W.numpy(), **SHARDED)
    for alg in ("cd", "greedycd"):
        a = nt.nnmf(X, k, mesh=mesh, parallel_replicates=True,
                    **{**kw, "alg": alg})
        b = nt.nnmf(X, k, parallel_replicates=True, **{**kw, "alg": alg})
        assert a.niters == b.niters
        np.testing.assert_allclose(a.W.numpy(), b.W.numpy(), **SHARDED)
    W0 = np.abs(rng.random((p, k)))
    H0 = np.abs(rng.random((k, n))) + 0.01
    ret = nt.nnmf(X, k, alg="cd", init="custom", W0=W0, H0=H0, update_H=False,
                  maxiter=8, mesh=mesh, device="cpu")
    assert np.array_equal(ret.H.numpy(), H0)


def test_layout_and_transpose():
    X = torch.from_numpy(_problem(p=30, n=47)[0])
    Xs = ds.shard_dense(X, cpu_mesh((2, 4)))
    assert Xs.row_cuts == (0, 15, 30) and Xs.col_cuts == (0, 12, 24, 36, 47)
    for i, row in enumerate(Xs.blocks):
        for j, b in enumerate(row):
            assert b.is_contiguous()
            assert torch.equal(b, X[Xs.row_cuts[i]:Xs.row_cuts[i + 1],
                                    Xs.col_cuts[j]:Xs.col_cuts[j + 1]])
    Xt = matops.transpose(Xs)
    assert Xt.shape == (47, 30) and matops.is_sharded_dense(Xt)
    D = torch.rand(30, 3, dtype=torch.float64)
    np.testing.assert_allclose(matops.mm(Xt, D).numpy(), (X.T @ D).numpy(), **BLOCKS)
    one = ds.shard_dense(X, cpu_mesh((1, 1)))
    assert one.blocks[0][0].data_ptr() == X.data_ptr()  # no copy
    for fn in (matops.sq_norm, matops.total_sum):
        np.testing.assert_allclose(fn(Xs).numpy(), fn(X).numpy(), **BLOCKS)
        assert torch.equal(fn(one), fn(X))
    assert bool(matops.all_nonneg(Xs))
    assert not matops.all_nonneg(ds.shard_dense(-X, cpu_mesh((2, 4))))


@pytest.mark.parametrize("shape", [(2, 4), (1, 1)])
def test_block_products_against_the_whole_x(shape):
    """mm, mtm, the quotient products (kernels 8 and 9's plain versions a
    block) and both objectives (kernel 6's)."""
    X, W, H = (torch.from_numpy(a) for a in _problem(seed=7, p=37, n=29, k=5))
    Xs = ds.shard_dense(X, cpu_mesh(shape))
    D, E = torch.rand(29, 6, dtype=torch.float64), torch.rand(6, 37, dtype=torch.float64)
    delta = 1e-8
    pairs = [(matops.mm(Xs, D), X @ D), (matops.mtm(E, Xs), E @ X),
             (matops.wtq(Xs, W, H, delta), wtq_plain(X, W, H, delta)),
             (matops.qht(Xs, W, H, delta), qht_plain(X, W, H, delta)),
             (mse_objective(Xs, W, H), mse_objective(X, W, H)),
             (kl_objective(Xs, W, H), kl_objective(X, W, H))]
    for got, want in pairs:
        if shape == (1, 1):
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **BLOCKS)


def test_init_on_a_prebuilt_grid_and_errors():
    X, _, _ = _problem(seed=9)
    mesh = cpu_mesh((2, 4))
    Xs = ds.shard_dense(torch.from_numpy(X), mesh)
    # NNDSVD runs on the grid itself through its products
    got = nt.nnmf(Xs, 4, maxiter=3, mesh=mesh, device="cpu")
    want = nt.nnmf(X, 4, maxiter=3, mesh=mesh, device="cpu")
    np.testing.assert_allclose(got.W.numpy(), want.W.numpy(), **SHARDED)
    with pytest.raises(ValueError, match="different mesh"):
        nt.nnmf(Xs, 4, mesh=cpu_mesh((1, 1)), device="cpu")
    with pytest.raises(ValueError, match="spa takes a whole dense X"):
        nt.spa(Xs, 4, device="cpu")
    # SPA runs on X before the cut; the objective sums the blocks
    res = nt.nnmf(X, 4, init="spa", alg="spa", mesh=mesh, device="cpu")
    want = nt.nnmf(X, 4, init="spa", alg="spa", device="cpu")
    assert torch.equal(res.W, want.W) and torch.equal(res.H, want.H)
    assert np.isclose(res.objvalue, want.objvalue, rtol=1e-12)
