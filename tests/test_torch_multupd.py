"""Multiplicative updates of the PyTorch build against the JAX package's: one
sweep of each objective, the KL objective, whole solves through ``nnmf`` and
``solve``, the options' validation and recovery of a unique factorization.

Tolerances:

* dense float64, one sweep: ``rtol=1e-10`` — the same arithmetic in the same
  order but for the matrix products' internal summation;
* tiled store (float32 products on both sides, summed in another order) with
  float64 factors, one sweep: ``rtol=2e-5``;
* 30 iterations: the sweep's difference fed back 30 times, ``rtol=1e-8``
  dense float64 and ``rtol=2e-4`` on the tiled store."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models import multupd as jmu
from nmf_tpu.ops import objectives as jobj
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch import convert
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.models import multupd as tmu
from nmf_tpu_torch.ops import objectives as tobj
from nmf_tpu_torch.ops.cuda import objectives as tobj_plain
from nmf_tpu_torch.ops.sparse_format import build_tiled

from testproblems import laurberg6x3
from torch_parity import BUILD, coo_of, three_class_matrix

K = 6
F64 = dict(rtol=1e-10, atol=1e-14)
TILED = dict(rtol=2e-5, atol=1e-8)

REG = [dict(), dict(lambda_w=0.02, lambda_h=0.05), dict(update_H=False)]


def _problem(dtype=np.float64, seed=0):
    Xd = three_class_matrix(seed).astype(dtype)
    rng = np.random.default_rng(seed + 30)
    W = rng.random((Xd.shape[0], K)).astype(dtype)
    H = rng.random((K, Xd.shape[1])).astype(dtype)
    return Xd, W, H


def _tiled_pair(Xd, **opts):
    r, c, v = coo_of(Xd.astype(np.float32))
    opts = dict(BUILD, **opts)
    return (jax_build_tiled(r, c, v, Xd.shape, **opts),
            build_tiled(r, c, v, Xd.shape, device="cpu", **opts))


def _sweep_pair(obj, reg, Xj, Xt, W, H):
    # the JAX sweep runs under jit, as the JAX package's own loop runs it: on
    # the tiled store its products are interpret-mode Pallas calls, and eager
    # dispatch beside one still in flight can deadlock
    upd = jmu.MultUpdate(obj=obj, **reg)
    want = jax.jit(lambda X, W, H: jmu._update(upd, (), X, W, H))(
        Xj, jnp.asarray(W), jnp.asarray(H))
    got = tmu._update(tmu.MultUpdate(obj=obj, **reg), (), Xt,
                      torch.from_numpy(W), torch.from_numpy(H))
    return got, want


@pytest.mark.parametrize("obj", ["mse", "div"])
@pytest.mark.parametrize("reg", REG, ids=["plain", "l1", "fixed_H"])
def test_one_sweep_dense_f64(obj, reg):
    Xd, W, H = _problem()
    (Wt, Ht, st), (Wj, Hj, _) = _sweep_pair(obj, reg, jnp.asarray(Xd), torch.from_numpy(Xd), W, H)
    assert st == () and Wt.dtype == Ht.dtype == torch.float64
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **F64)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **F64)
    if "update_H" in reg:
        assert torch.equal(Ht, torch.from_numpy(H))
    assert not torch.equal(Wt, torch.from_numpy(W))


@pytest.mark.parametrize("obj", ["mse", "div"])
@pytest.mark.parametrize("reg", REG, ids=["plain", "l1", "fixed_H"])
@pytest.mark.parametrize("order", ["degree", "natural"])
def test_one_sweep_tiled(obj, reg, order):
    Xd, W, H = _problem()
    Xj, Xt = _tiled_pair(Xd, order=order)
    (Wt, Ht, _), (Wj, Hj, _) = _sweep_pair(obj, reg, Xj, Xt, W, H)
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), **TILED)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), **TILED)
    # and the tiled sweep is the dense sweep
    Wd, Hd, _ = tmu._update(tmu.MultUpdate(obj=obj, **reg), (),
                            torch.from_numpy(Xd), torch.from_numpy(W), torch.from_numpy(H))
    np.testing.assert_allclose(Wt.numpy(), Wd.numpy(), **TILED)
    np.testing.assert_allclose(Ht.numpy(), Hd.numpy(), **TILED)


def test_sweeps_leave_their_inputs_alone():
    Xd, W, H = _problem()
    Wt, Ht = torch.from_numpy(W.copy()), torch.from_numpy(H.copy())
    for obj in ("mse", "div"):
        tmu._update(tmu.MultUpdate(obj=obj), (), torch.from_numpy(Xd), Wt, Ht)
        assert torch.equal(Wt, torch.from_numpy(W)) and torch.equal(Ht, torch.from_numpy(H))


# ---------------------------------------------------------------------------
# the KL objective


def test_gkldiv_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.random((40, 30))
    a[rng.random(a.shape) < 0.3] = 0.0
    b = rng.random((40, 30))
    b[0, :3] = 0.0  # a zero model value: its logarithm is guarded
    np.testing.assert_allclose(
        float(tobj.gkldiv(torch.from_numpy(a), torch.from_numpy(b))),
        float(jobj.gkldiv(jnp.asarray(a), jnp.asarray(b))), rtol=1e-12)


@pytest.mark.parametrize("form", ["small", "blockwise"])
def test_kl_objective_dense(form, monkeypatch):
    Xd, W, H = _problem()
    if form == "blockwise":  # both packages switch to column blocks above _SMALL
        monkeypatch.setattr(tobj, "_SMALL", 1000)
        monkeypatch.setattr(tobj_plain, "_BLOCK_N", 100)
        monkeypatch.setattr(jobj, "_SMALL", 1000)
        monkeypatch.setattr(jobj, "_BLOCK_N", 100)
    got = tobj.kl_objective(*(torch.from_numpy(a) for a in (Xd, W, H)))
    want = jobj.kl_objective(*(jnp.asarray(a) for a in (Xd, W, H)))
    assert got.dim() == 0 and got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    np.testing.assert_allclose(
        float(got), float(tobj.gkldiv(torch.from_numpy(Xd), torch.from_numpy(W @ H))),
        rtol=1e-12)
    got = tobj.mse_objective(*(torch.from_numpy(a) for a in (Xd, W, H)))
    want = jobj.mse_objective(*(jnp.asarray(a) for a in (Xd, W, H)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("order", ["degree", "natural"])
def test_kl_objective_sparse(order):
    Xd, W, H = _problem()
    Xj, Xt = _tiled_pair(Xd, order=order)
    got = tobj.kl_objective(Xt, torch.from_numpy(W), torch.from_numpy(H))
    want = jobj.kl_objective(Xj, jnp.asarray(W), jnp.asarray(H))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    # the sparse form is the dense one
    dense = tobj.kl_objective(*(torch.from_numpy(a) for a in (Xd, W, H)))
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole


def _same_result(rt, rj, tol):
    assert rt.niters == rj.niters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), **tol)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), **tol)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=tol["rtol"])


@pytest.mark.parametrize("alg", ["multmse", "multdiv"])
def test_nnmf_thirty_iterations_dense_f64(alg):
    Xd, W0, H0 = _problem()
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=30, tol=1e-30, trace=True)
    rj = nmf_tpu.nnmf(jnp.asarray(Xd), K, **kw)
    rt = nt.nnmf(Xd, K, device="cpu", **kw)
    assert rt.niters == 30 and not rt.converged and rt.W.dtype == torch.float64
    _same_result(rt, rj, dict(rtol=1e-8, atol=1e-12))
    np.testing.assert_allclose(rt.trace.objvalue.numpy(), np.asarray(rj.trace.objvalue), rtol=1e-8)
    np.testing.assert_allclose(rt.trace.relchange.numpy(), np.asarray(rj.trace.relchange), rtol=1e-6)
    # multiplicative updates never raise their objective
    objs = rt.trace.objvalue.numpy()
    assert (np.diff(objs) <= 1e-12 * objs[:-1]).all()


@pytest.mark.parametrize("alg", ["multmse", "multdiv"])
@pytest.mark.parametrize("order", ["degree", "natural"])
def test_nnmf_thirty_iterations_tiled(alg, order):
    Xd, W0, H0 = _problem(np.float32)
    Xj, Xt = _tiled_pair(Xd, order=order)
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=30, tol=1e-30)
    rj = nmf_tpu.nnmf(Xj, K, **kw)
    rt = nt.nnmf(Xt, K, device="cpu", **kw)
    assert rt.niters == 30 and rt.W.dtype == torch.float32
    _same_result(rt, rj, dict(rtol=2e-4, atol=1e-6))
    # the tiled solve is the dense solve
    rd = nt.nnmf(Xd, K, device="cpu", **kw)
    np.testing.assert_allclose(rt.W.numpy(), rd.W.numpy(), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(rt.objvalue, rd.objvalue, rtol=1e-4)


def test_div_on_a_degree_ordered_store_through_solve():
    """``MultUpdate`` is renumber-safe: ``solve`` runs the whole divergence
    solve in the store's renumbered coordinates (the sampled product skips its
    permutation, the value refresh keeps CSR order) and hands back factors in
    the caller's coordinates."""
    Xd, W0, H0 = _problem(np.float32, seed=1)
    Xj, Xt = _tiled_pair(Xd, order="degree")
    assert Xt.row_perm is not None and tcommon._renumber_ok(tmu.MultUpdate(obj="div"), Xt)
    opts = dict(obj="div", maxiter=8, tol=1e-30, lambda_h=0.01)
    rj = nmf_tpu.solve(jmu.MultUpdate(**opts), Xj, jnp.asarray(W0), jnp.asarray(H0))
    Wt, Ht = torch.from_numpy(W0), torch.from_numpy(H0)
    rt = nt.solve(nt.MultUpdate(**opts), Xt, Wt, Ht, device="cpu")
    _same_result(rt, rj, dict(rtol=1e-4, atol=1e-6))
    assert torch.equal(Wt, torch.from_numpy(W0)) and torch.equal(Ht, torch.from_numpy(H0))
    # the same solve without renumbering (natural order) and on dense X
    _, Xn = _tiled_pair(Xd, order="natural")
    rn = nt.solve(nt.MultUpdate(**opts), Xn, Wt, Ht, device="cpu")
    rd = nt.solve(nt.MultUpdate(**opts), torch.from_numpy(Xd), Wt, Ht, device="cpu")
    for other in (rn, rd):
        np.testing.assert_allclose(rt.W.numpy(), other.W.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rt.H.numpy(), other.H.numpy(), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(rt.objvalue, other.objvalue, rtol=1e-4)
    # the objective it reports is the KL divergence of the returned factors
    np.testing.assert_allclose(
        rt.objvalue, float(tobj.kl_objective(torch.from_numpy(Xd), rt.W, rt.H)), rtol=1e-4)


def test_solve_stops_at_the_same_iteration():
    Xd, W0, H0 = _problem()
    for obj in ("mse", "div"):
        rj = nmf_tpu.solve(jmu.MultUpdate(obj=obj, maxiter=200, tol=2e-3),
                           jnp.asarray(Xd), jnp.asarray(W0), jnp.asarray(H0))
        rt = nt.solve(nt.MultUpdate(obj=obj, maxiter=200, tol=2e-3), torch.from_numpy(Xd),
                      torch.from_numpy(W0), torch.from_numpy(H0), device="cpu")
        assert rt.converged and 3 < rt.niters < 200
        _same_result(rt, rj, dict(rtol=1e-7, atol=1e-12))


def test_random_init_and_update_H_false():
    Xd, _, H0 = _problem(np.float32)
    for alg in ("multmse", "multdiv"):
        a = nt.nnmf(Xd, K, alg=alg, init="random", maxiter=5, seed=3, device="cpu")
        b = nt.nnmf(Xd, K, alg=alg, init="random", maxiter=5, seed=3, device="cpu")
        assert a == b and a.niters == 5
        assert bool((a.W >= 0).all()) and bool((a.H >= 0).all())
    W0 = np.random.default_rng(2).random((Xd.shape[0], K), dtype=np.float32)
    res = nt.nnmf(Xd, K, alg="multdiv", init="custom", W0=W0, H0=H0, maxiter=3,
                  update_H=False, device="cpu")
    assert torch.equal(res.H, torch.from_numpy(H0))
    assert not torch.equal(res.W, torch.from_numpy(W0))


# ---------------------------------------------------------------------------
# the options


@pytest.mark.parametrize("bad", [
    dict(obj="bogus"), dict(maxiter=1), dict(tol=0.0), dict(lambda_w=-1.0),
    dict(lambda_h=-1.0),
])
def test_multupd_validation(bad):
    with pytest.raises(ValueError) as et:
        nt.MultUpdate(**bad)
    with pytest.raises(ValueError) as ej:
        nmf_tpu.MultUpdate(**bad)
    assert str(et.value) == str(ej.value)


def test_multupd_options_match_the_jax_packages():
    fj = {f.name: f.default for f in dataclasses.fields(nmf_tpu.MultUpdate)}
    ft = {f.name: f.default for f in dataclasses.fields(nt.MultUpdate)}
    assert ft == fj
    for dtype, tdtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        assert nt.MultUpdate()._resolved(tdtype)[1] == nmf_tpu.MultUpdate()._resolved(dtype)[1]
    assert nt.MultUpdate(tol=0.25)._resolved(torch.float32)[1] == 0.25
    assert tcommon._impl_for(nt.MultUpdate()).renumber_safe is True


def test_deprecated_lam_keyword():
    with pytest.warns(DeprecationWarning, match="lam is deprecated"):
        upd = nt.MultUpdate(lam=0.5, lambda_h=0.1)
    assert (upd.lambda_w, upd.lambda_h) == (0.5, 0.1)
    with pytest.warns(DeprecationWarning):
        ref = nmf_tpu.MultUpdate(lam=0.5, lambda_h=0.1)
    assert (ref.lambda_w, ref.lambda_h) == (0.5, 0.1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nt.MultUpdate(lambda_w=0.5)


def test_options_and_result_carried_over_from_jax():
    Xd, W0, H0 = _problem()
    ref = nmf_tpu.MultUpdate(obj="div", maxiter=4, tol=1e-30, lambda_w=0.01)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    upd = convert.solver_from_fields("MultUpdate", fields)
    assert upd == nt.MultUpdate(obj="div", maxiter=4, tol=1e-30, lambda_w=0.01)
    cd = convert.solver_from_fields("CoordinateDescent", dict(maxiter=7, alpha=0.5, key=None))
    assert (cd.maxiter, cd.alpha, cd.generator) == (7, 0.5, None)
    with pytest.raises(NotImplementedError, match="ProjectedALS"):
        convert.solver_from_fields("ProjectedALS", {})
    with pytest.raises(ValueError, match="Invalid value for obj"):
        convert.solver_from_fields("MultUpdate", dict(obj="bogus"))

    rj = nmf_tpu.solve(ref, jnp.asarray(Xd), jnp.asarray(W0), jnp.asarray(H0), trace=True)
    carried = convert.result_from_numpy(
        dict(W=np.asarray(rj.W), H=np.asarray(rj.H), niters=rj.niters,
             converged=rj.converged, objvalue=rj.objvalue,
             trace=(np.asarray(rj.trace.objvalue), np.asarray(rj.trace.relchange))),
        device="cpu")
    rt = nt.solve(upd, torch.from_numpy(Xd), torch.from_numpy(W0), torch.from_numpy(H0),
                  trace=True, device="cpu")
    _same_result(rt, carried, dict(rtol=1e-9, atol=1e-13))
    assert isinstance(carried, nt.Result) and carried.trace.objvalue.shape == (4,)
    plain = convert.result_from_numpy(
        dict(W=W0, H=H0, niters=0, converged=False, objvalue=1.0), device="cpu")
    assert plain.trace is None and plain.W.dtype == torch.float64


# ---------------------------------------------------------------------------
# recovery of a unique factorization


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("obj", ["mse", "div"])
@pytest.mark.parametrize("reg", [(0.0, 0.0), (1e-4, 1e-4)])
def test_multupd_recovery(dtype, obj, reg):
    rng = np.random.default_rng(42)
    X, Wg, Hg = laurberg6x3(dtype(0.3), dtype)
    W = (Wg + rng.random(Wg.shape) * 0.1).astype(dtype)
    res = nt.solve(
        nt.MultUpdate(obj=obj, maxiter=5000, tol=1e-9, lambda_w=reg[0], lambda_h=reg[1]),
        torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(Hg), device="cpu",
    )
    Wr, Hr = res.W.numpy(), res.H.numpy()
    assert (Wr >= 0).all() and (Hr >= 0).all()
    assert not np.isnan(Wr).any() and not np.isnan(Hr).any()
    assert np.allclose(X, Wr @ Hr, atol=1e-2)
