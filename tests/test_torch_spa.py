"""SPA and FNNLS of the PyTorch build against the JAX package's: the same
numpy inputs (from a seed) through both, on the CPU.

Tolerances: FNNLS in float64 within ``atol=1e-10`` of the JAX package and
``1e-8`` of ``scipy.optimize.nnls`` (the JAX package's own bound); the
cascade gives the plain driver's bits.  SPA picks the same anchors (exact),
so W is the same columns of X (exact), and H agrees within ``atol=1e-9`` in
float64.  On the tiled store, whose products are float32 summed in another
order on each side, the anchors are the same and H agrees within
``rtol=1e-4, atol=1e-5``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import nnls as scipy_nnls

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models.spa import _spa_anchors_sparse as jax_anchors_sparse
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch import config, convert
from nmf_tpu_torch.models import spa as tspa
from nmf_tpu_torch.ops import fnnls
from nmf_tpu_torch.ops.sparse_format import build_tiled

from torch_parity import BUILD, coo_of, three_class_matrix


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _mixed_problem(seed=83, m=40, k=8, n=600):
    """Interior columns (one outer step), x = 0 columns, and random ones with
    active constraints: the JAX package's cascade problem."""
    rng = np.random.default_rng(seed)
    A = rng.random((m, k))
    B = rng.random((m, n)) - 0.4
    B[:, :50] = A @ (rng.random((k, 50)) + 0.5)
    B[:, 50:80] = -np.abs(B[:, 50:80])
    return A, B


def test_nnls_gram_matches_jax_and_scipy():
    A, B = _mixed_problem(n=120)
    AtA, AtB = A.T @ A, A.T @ B
    xj = np.asarray(nmf_tpu.nnls_gram(jnp.asarray(AtA), jnp.asarray(AtB), cascade=False))
    xt = nt.nnls_gram(*_t(AtA, AtB), device="cpu").numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)
    for j in (0, 55, 90, 119):
        expect, _ = scipy_nnls(A, B[:, j])
        assert np.allclose(xt[:, j], expect, atol=1e-8), j


def test_fnnls_matches_jax_and_scipy():
    rng = np.random.default_rng(81)
    A, B = rng.random((20, 6)), rng.random((20, 15))
    xj = np.asarray(nmf_tpu.fnnls(jnp.asarray(A), jnp.asarray(B)))
    xt = nt.fnnls(*_t(A, B), device="cpu").numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)
    for j in range(15):
        expect, _ = scipy_nnls(A, B[:, j])
        assert np.allclose(xt[:, j], expect, atol=1e-8), j
    # precise: float32 in, float64 inside, float32 out
    x32 = nt.fnnls(*_t(A.astype(np.float32), B.astype(np.float32)), device="cpu")
    assert x32.dtype == torch.float32
    np.testing.assert_allclose(x32.numpy(), xt, rtol=0, atol=1e-5)


def test_fnnls_cascade_gives_the_plain_drivers_bits():
    A, B = _mixed_problem()
    AtA, AtB = _t(A.T @ A, A.T @ B)
    widths = []
    run = fnnls._run

    def recording_run(AtA, c, *a):
        widths.append(c.x.shape[0])
        return run(AtA, c, *a)

    old = dict(config.fnnls_cascade)
    try:
        config.set_fnnls_cascade(shrink=3, min=16, off_cols=1)
        fnnls._run = recording_run
        fast = nt.nnls_gram(AtA, AtB, device="cpu")
    finally:
        fnnls._run = run
        config.set_fnnls_cascade(**old)
    plain = nt.nnls_gram(AtA, AtB, cascade=False, device="cpu")
    assert torch.equal(fast, plain)
    # buffers of 600, then of the active columns at most 200, 66 and 22
    assert widths[0] == 600 and len(widths) >= 2
    assert all(w <= cap for w, cap in zip(widths[1:], (200, 66, 22)))
    for j in (0, 55, 120, 599):
        expect, _ = scipy_nnls(A, B[:, j])
        assert np.allclose(plain[:, j].numpy(), expect, atol=1e-8), j


@pytest.mark.parametrize("bad", [dict(shrink=1), dict(min=0), dict(off_cols=0),
                                 dict(shrink=2.0), dict(min=True)])
def test_set_fnnls_cascade_validates(bad):
    old = dict(config.fnnls_cascade)
    with pytest.raises(ValueError, match="cascade"):
        config.set_fnnls_cascade(**bad)
    assert config.fnnls_cascade == old
    config.set_fnnls_cascade(shrink=5)
    assert config.fnnls_cascade == dict(old, shrink=5)
    config.set_fnnls_cascade(**old)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spa_on_dense_x_matches_jax(dtype):
    p, n, k = 15, 8, 2
    rng = np.random.default_rng(41)
    eps4 = np.finfo(dtype).eps ** 0.25
    Wg = np.maximum(rng.random((p, k)) - 0.3, eps4)
    Hg = np.maximum(rng.random((k, n)) - 0.3, eps4)
    X = (Wg @ Hg).astype(dtype)
    wj, hj = nmf_tpu.spa(jnp.asarray(X), k)
    wt, ht = nt.spa(torch.from_numpy(X), k, device="cpu")
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=1e-9 if dtype == np.float64 else 1e-5)
    assert (ht >= 0).all() and np.allclose((wt @ ht).numpy(), X, atol=10.0 * eps4)


def test_spa_on_the_tiled_store_matches_jax():
    Xd = three_class_matrix(3)
    r, c, v = coo_of(Xd)
    k = 6
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    aj = np.asarray(jax_anchors_sparse(Xj, k))
    at = tspa._spa_anchors_sparse(Xt, k).numpy()
    np.testing.assert_array_equal(at, aj)
    wj, hj = jax.jit(nmf_tpu.spa, static_argnums=1)(Xj, k)
    wt, ht = nt.spa(Xt, k, device="cpu")
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(wt.numpy(), Xd[:, at])
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_spa_recovers_separable_data_exactly(dtype):
    p, n, k = 15, 8, 2
    Wg, Hg = nt.separable_data(p, n, k, generator=torch.Generator().manual_seed(5),
                               dtype=dtype, device="cpu")
    X = Wg @ Hg
    w, h = nt.spa(X, k, device="cpu")
    assert (w >= 0).all() and (h >= 0).all()
    assert float(nt.sqL2dist(X, w @ h)) < torch.finfo(dtype).eps


def test_separable_data_structure():
    p, n, k = 10, 7, 3
    _, H = nt.separable_data(p, n, k, generator=torch.Generator().manual_seed(1),
                             dtype=torch.float64, device="cpu")
    H = H.numpy()
    cols = {tuple(np.round(H[:, j], 12)) for j in range(n)}
    for r in range(k):
        assert tuple(1.0 if i == r else 0.0 for i in range(k)) in cols
    assert (H.sum(axis=0) <= 1 + 1e-12).all()


def test_spa_solver_statistics_match_jax():
    rng = np.random.default_rng(43)
    W, H = rng.random((12, 3)), rng.random((3, 9))
    X = W @ H + 0.1
    for obj in ("mse", "div"):
        rj = nmf_tpu.solve(nmf_tpu.SPA(obj=obj), *map(jnp.asarray, (X, W, H)))
        rt = nt.solve(nt.SPA(obj=obj), *_t(X, W, H), device="cpu")
        assert (rt.niters, rt.converged) == (0, True)
        np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-12)
    with pytest.raises(ValueError, match="Invalid value for obj"):
        nt.SPA(obj="bogus")
    fields = {f.name: getattr(nmf_tpu.SPA(obj="div"), f.name)
              for f in dataclasses.fields(nmf_tpu.SPA)}
    assert convert.solver_from_fields("SPA", fields) == nt.SPA(obj="div")


def test_nnmf_spa_matches_jax():
    rng = np.random.default_rng(44)
    X = rng.random((20, 3)) @ rng.random((3, 16))
    rj = nmf_tpu.nnmf(jnp.asarray(X), 3, init="spa", alg="spa")
    rt = nt.nnmf(torch.from_numpy(X), 3, init="spa", alg="spa", device="cpu")
    np.testing.assert_array_equal(rt.W.numpy(), np.asarray(rj.W))
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=0, atol=1e-9)
    assert (rt.niters, rt.converged) == (0, True)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-6, atol=1e-20)
