"""Fast-HALS of the PyTorch build against the JAX package's: one half-step
and one whole update, on dense X in float64 and on the tiled X in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmf_tpu.models import coorddesc as jcd
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch.models import coorddesc as tcd
from nmf_tpu_torch.ops.objectives import mse_objective, sqL2dist
from nmf_tpu_torch.ops.sparse_format import build_tiled

from torch_parity import BUILD, coo_of, three_class_matrix

REG = [
    dict(),
    dict(alpha=0.3, l1ratio=0.4),
    dict(alpha=0.2, l1ratio=1.0, regularization="components"),
    dict(alpha=0.2, l1ratio=0.0, regularization="transformation"),
]


def _problem(dtype, k=6, seed=0):
    Xd = three_class_matrix(seed).astype(dtype)
    rng = np.random.default_rng(seed + 10)
    W = rng.random((Xd.shape[0], k)).astype(dtype)
    H = rng.random((k, Xd.shape[1])).astype(dtype)
    return Xd, W, H


def _tiled_pair(Xd):
    r, c, v = coo_of(Xd)
    return (jax_build_tiled(r, c, v, Xd.shape, **BUILD),
            build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD))


# dense float64: the same arithmetic in the same order but for the matrix
# products' internal summation -> 1e-10; atol for entries at the clamp, where
# one side gives 0 and the other a rounding residue of a few 1e-16
F64 = dict(rtol=1e-10, atol=1e-13)
# tiled float32: products summed in another order, fed through k sequential
# column updates -> 1e-4 (atol for entries clamped near 0)
F32 = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("l1, l2", [(0.0, 0.0), (0.05, 0.1)])
def test_halfstep_dense_f64(l1, l2):
    Xd, W, H = _problem(np.float64)
    k = W.shape[1]
    want = jcd._halfstep(jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(H),
                         l1, l2, jnp.arange(k))
    got = tcd._halfstep(torch.from_numpy(Xd), torch.from_numpy(W),
                        torch.from_numpy(H), l1, l2, range(k))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    # a visit order other than 0..k-1
    order = [3, 0, 5, 1, 4, 2]
    want = jcd._halfstep(jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(H),
                         l1, l2, jnp.asarray(order))
    got = tcd._halfstep(torch.from_numpy(Xd), torch.from_numpy(W),
                        torch.from_numpy(H), l1, l2, order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_halfstep_leaves_its_input_alone_and_skips_zero_hessian():
    Xd, W, H = _problem(np.float64)
    H[2] = 0.0  # component 2 has a zero Hessian: its column stays
    Wt = torch.from_numpy(W.copy())
    got = tcd._halfstep(torch.from_numpy(Xd), Wt, torch.from_numpy(H), 0.0, 0.0, range(6))
    assert torch.equal(Wt, torch.from_numpy(W))
    assert torch.equal(got[:, 2], Wt[:, 2])
    want = jcd._halfstep(jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(H),
                         0.0, 0.0, jnp.arange(6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


@pytest.mark.parametrize("l1, l2", [(0.0, 0.0), (0.05, 0.1)])
def test_halfstep_tiled_f32(l1, l2):
    Xd, W, H = _problem(np.float32)
    Xj, Xt = _tiled_pair(Xd)
    k = W.shape[1]
    want = jcd._halfstep(Xj, jnp.asarray(W), jnp.asarray(H), l1, l2, jnp.arange(k))
    got = tcd._halfstep(Xt, torch.from_numpy(W), torch.from_numpy(H), l1, l2, range(k))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("reg", REG)
@pytest.mark.parametrize("update_H", [True, False])
def test_update_dense_f64(reg, update_H):
    Xd, W, H = _problem(np.float64)
    uj, _ = jcd.CoordinateDescent(update_H=update_H, **reg)._resolved(np.float64)
    ut, _ = tcd.CoordinateDescent(update_H=update_H, **reg)._resolved(torch.float64)
    Wj, Hj, _ = jcd._update(uj, jcd._prepare(uj, None, None, None),
                            jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(H))
    Wt, Ht, _ = tcd._update(ut, tcd._prepare(ut, None, None, None),
                            torch.from_numpy(Xd), torch.from_numpy(W), torch.from_numpy(H))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **F64)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **F64)
    if not update_H:
        assert torch.equal(Ht, torch.from_numpy(H))


@pytest.mark.parametrize("reg", REG[:2])
def test_update_tiled_f32(reg):
    Xd, W, H = _problem(np.float32)
    Xj, Xt = _tiled_pair(Xd)
    uj, _ = jcd.CoordinateDescent(**reg)._resolved(np.float32)
    ut, _ = tcd.CoordinateDescent(**reg)._resolved(torch.float32)
    Wj, Hj, _ = jcd._update(uj, jcd._prepare(uj, Xj, None, None), Xj,
                            jnp.asarray(W), jnp.asarray(H))
    Wt, Ht, _ = tcd._update(ut, tcd._prepare(ut, Xt, None, None), Xt,
                            torch.from_numpy(W), torch.from_numpy(H))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **F32)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **F32)


@pytest.mark.parametrize("reg", REG)
def test_regsplit_matches_jax(reg):
    uj = jcd.CoordinateDescent(**reg)
    ut = tcd.CoordinateDescent(**reg)
    want = [float(x) for x in jcd._regsplit(uj, jnp.float64)]
    np.testing.assert_allclose(tcd._regsplit(ut), want, rtol=1e-15)


def test_options():
    with pytest.raises(ValueError, match="regularization"):
        tcd.CoordinateDescent(regularization="everything")
    upd, tol = tcd.CoordinateDescent()._resolved(torch.float32)
    from nmf_tpu.utils.dtypes import cbrt_eps as jax_cbrt_eps

    assert tol == jax_cbrt_eps(np.float32) == float(np.cbrt(float(np.finfo(np.float32).eps)))
    assert isinstance(upd.generator, torch.Generator)
    assert tcd.CoordinateDescent(tol=0.5)._resolved(torch.float64)[1] == 0.5
    with pytest.raises(Exception):
        upd.maxiter = 3  # frozen


def test_shuffle_is_a_permutation_of_the_sweep_and_repeats_with_its_seed():
    Xd, W, H = _problem(np.float64)
    args = (torch.from_numpy(Xd), torch.from_numpy(W), torch.from_numpy(H))

    def run(seed):
        upd = tcd.CoordinateDescent(shuffle=True,
                                    generator=torch.Generator().manual_seed(seed))
        return tcd._update(upd, tcd._prepare(upd, *args), *args)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    plain = tcd._update(tcd.CoordinateDescent(), (None,), *args)
    assert not torch.equal(a[0], plain[0])
    # still a descent step from the same start
    f = lambda W, H: float(mse_objective(args[0], W, H))
    assert f(a[0], a[1]) < f(args[1], args[2])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mse_objective_paths_agree(dtype, monkeypatch):
    from nmf_tpu.ops import objectives as jobj
    from nmf_tpu_torch.ops import objectives as tobj
    from nmf_tpu_torch.ops.cuda import objectives as tobj_plain

    Xd, W, H = _problem(dtype)
    Xt, Wt, Ht = (torch.from_numpy(a) for a in (Xd, W, H))
    want = float(jobj.mse_objective(jnp.asarray(Xd), jnp.asarray(W), jnp.asarray(H)))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    small = float(tobj.mse_objective(Xt, Wt, Ht))
    np.testing.assert_allclose(small, want, rtol=rtol)
    assert float(sqL2dist(Xt, Wt @ Ht)) == pytest.approx(2 * small, rel=rtol)
    # the blockwise path: force it with a tiny threshold and block size
    monkeypatch.setattr(tobj, "_SMALL", 10)
    monkeypatch.setattr(tobj_plain, "_BLOCK_N", 64)
    np.testing.assert_allclose(float(tobj.mse_objective(Xt, Wt, Ht)), want, rtol=rtol)
    if dtype == np.float32:
        # the sparse Gram identity, against the JAX package's and the dense
        # value (a difference of large terms: 1e-4)
        Xj, Xtt = _tiled_pair(Xd)
        got = float(tobj.mse_objective(Xtt, Wt, Ht))
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(
            got, float(jobj.mse_objective(Xj, jnp.asarray(W), jnp.asarray(H))), rtol=1e-4
        )
