"""The ``nnmf`` defaults of the PyTorch build against the JAX package on the
CPU: shifted CholeskyQR3, the Cholesky solves, the randomized SVD given the
JAX package's own test matrix, the NNDSVD factors given its own ``ar`` draw,
``nndsvd`` from ``initdata``, a whole ``nnmf`` from an NNDSVD start, and the
column slabs of the sparse product.

Tolerances, float64 unless said: the two packages call the same LAPACK
routines and differ by the order of the sums in their matrix products, so
``rtol=1e-10`` for a CholeskyQR basis, ``1e-12`` for the solves and the
NNDSVD factors (elementwise work on equal inputs), ``1e-10`` / ``1e-9`` for
singular values / the rank-k product of the randomized SVD (two power
iterations and three QR passes between them), ``1e-8`` after a whole
GreedyCD solve, ``1e-4`` for singular values from a float32 tiled store
(float32 products summed in another order).  A rank-deficient panel's basis
is held on its range only: the columns past the rank complete the basis from
rounding noise in either package (they differ entirely), and its
orthonormality reaches 1e-8 in both (the JAX package's own reading on the
panel below is 7e-9 to 1.3e-8), so it is held at 1e-7."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.init.initialization import _nndsvd_factors as jax_nndsvd_factors
from nmf_tpu.ops.linalg import pdrsolve as jax_pdrsolve, pdsolve as jax_pdsolve
from nmf_tpu.ops.rsvd import rsvd as jax_rsvd
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu.ops.tsqr import cholesky_qr as jax_cholesky_qr
from nmf_tpu_torch.init.initialization import _nndsvd_factors
from nmf_tpu_torch.ops import linalg as tlinalg
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.rsvd import _rsvd_from_sketch
from nmf_tpu_torch.ops.sparse_format import build_tiled
from nmf_tpu_torch.ops.tsqr import cholesky_qr

from torch_parity import BUILD, coo_of, three_class_matrix


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _orth_err(Q):
    return np.abs(Q.T @ Q - np.eye(Q.shape[1])).max()


# ---------------------------------------------------------------------------
# shifted CholeskyQR3 and the Cholesky solves


def test_cholesky_qr_matches_jax_on_a_full_rank_panel():
    Y = np.random.default_rng(0).standard_normal((500, 20))
    want = np.asarray(jax.jit(jax_cholesky_qr)(jnp.asarray(Y)))
    got = cholesky_qr(*_t(Y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    assert _orth_err(got) <= 1e-12


def test_cholesky_qr_on_a_rank_deficient_panel():
    """l = 20 columns of rank 6, as an NNDSVD sketch of a low-rank X: the
    shift keeps every Gram positive definite."""
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((500, 6)) @ rng.standard_normal((6, 20))
    want = np.asarray(jax.jit(jax_cholesky_qr)(jnp.asarray(Y)))
    got = cholesky_qr(*_t(Y)).numpy()
    np.testing.assert_allclose(got[:, :6], want[:, :6], rtol=1e-10, atol=1e-10)
    # the basis spans Y, and is orthonormal as far as the reference's is
    assert np.abs(Y - got @ (got.T @ Y)).max() <= 1e-12 * np.abs(Y).max()
    assert _orth_err(got) <= 1e-7 and _orth_err(want) <= 1e-7


def test_cholesky_qr_raises_on_a_panel_with_nan():
    Y = torch.ones(50, 4, dtype=torch.float64)
    Y[3, 2] = float("nan")
    with pytest.raises(torch.linalg.LinAlgError, match="not positive definite"):
        cholesky_qr(Y)


def test_pdsolve_and_pdrsolve_match_jax():
    rng = np.random.default_rng(2)
    M = rng.standard_normal((7, 7))
    A = M @ M.T + 7 * np.eye(7)
    x, B = rng.standard_normal((7, 3)), rng.standard_normal((5, 7))
    v = rng.standard_normal(7)
    for got, want in (
        (tlinalg.pdsolve(*_t(A, x)), jax_pdsolve(jnp.asarray(A), jnp.asarray(x))),
        (tlinalg.pdsolve(*_t(A, v)), jax_pdsolve(jnp.asarray(A), jnp.asarray(v))),
        (tlinalg.pdrsolve(*_t(B, A)), jax_pdrsolve(jnp.asarray(B), jnp.asarray(A))),
    ):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)



def test_pdsolve_and_pdrsolve_give_nan_where_jax_does():
    """A Gram that is not positive definite: NaN, as the JAX package's
    ``cho_factor`` gives, and no exception."""
    A = np.array([[1.0, 2.0], [2.0, 1.0]])
    x, B = np.ones((2, 3)), np.ones((4, 2))
    for got, want in (
        (tlinalg.pdsolve(*_t(A, x)), jax_pdsolve(jnp.asarray(A), jnp.asarray(x))),
        (tlinalg.pdsolve(*_t(A, x[:, 0])), jax_pdsolve(jnp.asarray(A), jnp.asarray(x[:, 0]))),
        (tlinalg.pdrsolve(*_t(B, A)), jax_pdrsolve(jnp.asarray(B), jnp.asarray(A))),
    ):
        assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()

# ---------------------------------------------------------------------------
# the randomized SVD


def _jax_omega(key, n, l, dtype):
    ksvd, _ = jax.random.split(key)
    return ksvd, np.asarray(jax.random.normal(ksvd, (n, l), dtype=dtype))


def test_rsvd_from_the_jax_sketch_on_dense_x():
    rng = np.random.default_rng(3)
    X = rng.random((120, 10)) @ rng.random((10, 90)) + 0.01 * rng.random((120, 90))
    k = 6
    ksvd, omega = _jax_omega(jax.random.PRNGKey(4), 90, k + 10, jnp.float64)
    Uj, sj, Vj = (np.asarray(a) for a in jax_rsvd(jnp.asarray(X), k, key=ksvd))
    U, s, V = (a.numpy() for a in _rsvd_from_sketch(*_t(X, omega), k, 2))
    assert U.shape == (120, k) and s.shape == (k,) and V.shape == (90, k)
    np.testing.assert_allclose(s, sj, rtol=1e-10)
    want = (Uj * sj) @ Vj.T
    np.testing.assert_allclose((U * s) @ V.T, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_rsvd_from_the_jax_sketch_on_a_tiled_store():
    Xd = three_class_matrix(0)
    r, c, v = coo_of(Xd)
    k = 4
    ksvd, omega = _jax_omega(jax.random.PRNGKey(5), Xd.shape[1], k + 10, jnp.float32)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    sj = np.asarray(jax_rsvd(Xj, k, n_iter=1, key=ksvd)[1])
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    U, s, V = _rsvd_from_sketch(Xt, *_t(omega), k, 1)
    assert U.dtype == torch.float32 and tuple(V.shape) == (Xd.shape[1], k)
    np.testing.assert_allclose(s.numpy(), sj, rtol=1e-4)


def test_rsvd_draws_its_sketch_from_the_generator():
    rng = np.random.default_rng(6)
    X = torch.from_numpy(rng.random((40, 8)) @ rng.random((8, 30)))
    a = nt.rsvd(X, 5, generator=torch.Generator().manual_seed(9), device="cpu")
    omega = torch.randn((30, 15), generator=torch.Generator().manual_seed(9),
                        dtype=torch.float64)
    b = _rsvd_from_sketch(X, omega, 5, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_allclose(a[1].numpy(), np.linalg.svd(X.numpy())[1][:5], rtol=1e-10)


# ---------------------------------------------------------------------------
# NNDSVD


def _triplets(p=50, n=40, k=5, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.random((p, 6)) @ rng.random((6, n))
    U, s, Vt = np.linalg.svd(X, full_matrices=False)
    return X, U[:, :k], s[:k], Vt[:k].T


@pytest.mark.parametrize("inith", [True, False])
@pytest.mark.parametrize("variant", [0, 1, 2], ids=["std", "a", "ar"])
def test_nndsvd_factors_match_jax(variant, inith):
    X, U, s, V = _triplets()
    key = jax.random.PRNGKey(11)
    r = np.asarray(jax.random.uniform(key, (U.shape[1],), dtype=jnp.float64))
    Wj, Htj = jax_nndsvd_factors(jnp.asarray(U), jnp.asarray(s), jnp.asarray(V),
                                 float(X.mean()), variant, inith, key, jnp.float64)
    W, Ht = _nndsvd_factors(*_t(U, s, V), float(X.mean()), variant, inith,
                            torch.from_numpy(r), torch.float64)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-12)
    assert (Ht is None) == (Htj is None)
    if inith:
        np.testing.assert_allclose(Ht.numpy(), np.asarray(Htj), rtol=1e-12)


@pytest.mark.parametrize("form", ["tuple", "object"])
def test_nndsvd_takes_initdata(form):
    X, U, s, V = _triplets(k=8)
    k = 5
    data = (U, s, V) if form == "tuple" else SimpleNamespace(U=U, S=s, V=V)
    Wj, Hj = nmf_tpu.nndsvd(jnp.asarray(X), k, variant="a", initdata=data)
    W, H = nt.nndsvd(X, k, variant="a", initdata=data, device="cpu")
    assert W.dtype == H.dtype == torch.float64 and tuple(H.shape) == (k, 40)
    np.testing.assert_allclose(W.numpy(), np.asarray(Wj), rtol=1e-12)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-12)
    # tensors as well as arrays; zeroh leaves H at zero
    W2, H2 = nt.nndsvd(X, k, variant="a", initdata=_t(U, s, V), zeroh=True, device="cpu")
    assert torch.equal(W2, W) and not H2.any()


def test_nndsvd_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="Invalid value for variant"):
        nt.nndsvd(np.ones((4, 3)), 2, variant="b", device="cpu")


def test_nnmf_from_an_nndsvd_start_matches_jax():
    X, U, s, V = _triplets(p=60, n=48, k=5, seed=12)
    X = X + 0.01 * np.random.default_rng(13).random(X.shape)
    kw = dict(init="nndsvda", initdata=(U, s, V), alg="greedycd", maxiter=40)
    rj = nmf_tpu.nnmf(jnp.asarray(X), 5, **kw)
    rt = nt.nnmf(X, 5, device="cpu", **kw)
    assert rt.niters == rj.niters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, float(rj.objvalue), rtol=1e-8)


# ---------------------------------------------------------------------------
# the column slabs of the sparse product


@pytest.mark.parametrize("k", [3, 7, 8])
def test_tiled_product_in_column_slabs_gives_the_unslabbed_bits(k, monkeypatch):
    """With the kernels' column limit cut to 3, the whole chain runs per slab
    of D's columns; every output column is computed on its own, so the result
    is the unslabbed one to the bit."""
    Xd = three_class_matrix(1)
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    side = Xt.fwd
    D = torch.rand(side.cols, k, generator=torch.Generator().manual_seed(k))
    whole = tsp.tiled_matmul_t(side, D)
    monkeypatch.setattr(tsp, "MAX_K", 3)
    assert torch.equal(tsp.tiled_matmul_t(side, D), whole)
    np.testing.assert_allclose(tsp.tiled_mm(Xt, D).numpy(), Xd @ D.numpy(),
                               rtol=1e-5, atol=1e-5)
