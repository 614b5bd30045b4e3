"""Greedy coordinate descent of the PyTorch build against the JAX package on
dense X, on the CPU, and against a literal per-row loop.

Tolerances: float64 throughout, so the two packages differ by the order of
the sums inside their matrix products only: ``rtol=1e-10`` with
``atol=1e-13`` (an entry clamped to 0 on one side may read 1e-16 on the
other) for one half-step, ``rtol=1e-8`` after 6 iterations, ``atol=1e-12``
against the per-row oracle.  Different batchings of the rows inside the port
(cascade, slabs, one row at a time) must agree bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models import greedycd as jg
from nmf_tpu_torch import config, convert
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.models import greedycd as tg

from testproblems import laurberg6x3

F64 = dict(rtol=1e-10, atol=1e-13)


def _problem(p=60, n=48, k=5, seed=22, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.random((p, n)).astype(dtype), rng.random((p, k)).astype(dtype),
            rng.random((k, n)).astype(dtype))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture
def cascade():
    """Sets cascade knobs for one test and puts the old ones back."""
    old = dict(config.greedycd_cascade)
    yield config.set_greedycd_cascade
    config.greedycd_cascade.update(old)


# ---------------------------------------------------------------------------
# against the JAX package


def test_scores_match_jax():
    rng = np.random.default_rng(3)
    W, G = rng.random((7, 4)), rng.standard_normal((7, 4))
    Pdiag = rng.random(4) + 0.1
    denom = np.finfo(np.float64).eps + Pdiag
    Sj, Dj = jg._scores(jnp.asarray(W), jnp.asarray(G), jnp.asarray(denom),
                        jnp.asarray(Pdiag), jnp.float64)
    St, Dt = tg._scores(*_t(W, G, denom, Pdiag))
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), **F64)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), **F64)
    # a step never takes an entry below zero, and a score is never negative
    assert (W + St.numpy() >= 0).all() and (Dt.numpy() >= -1e-15).all()


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_halfstep_matches_jax(lam):
    X, W, H = _problem()
    want = np.asarray(jg._halfstep(jnp.asarray(X), jnp.asarray(W), jnp.asarray(H.T), lam))
    got = tg._halfstep(*_t(X, W, H.T), lam)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)
    # the H step by the transpose trick
    want = np.asarray(jg._halfstep(jnp.asarray(X.T), jnp.asarray(H.T), jnp.asarray(W), lam))
    np.testing.assert_allclose(tg._halfstep(*_t(X.T, H.T, W), lam).numpy(), want, **F64)


def _oracle(X, W, Ht, lam):
    """The per-row schedule written out: every row, on its own, applies its
    best coordinate until the best score falls below ``nu * p_init`` or
    ``k^2`` steps."""
    epsT = np.finfo(np.float64).eps
    m, k = W.shape
    P = Ht.T @ Ht
    Z = X @ Ht
    G = W @ P - Z + lam
    S = np.maximum(0.0, W - G / (epsT + np.diag(P))) - W
    D = -G * S - 0.5 * np.diag(P) * S**2
    q = D.argmax(axis=1)
    p_init = max(-1.0, D.max()) if D.size else -1.0
    Wnew = np.zeros_like(W)
    nu = 0.001
    for i in range(m):
        qi = q[i]
        for _ in range(k * k):
            if D[i, qi] < nu * p_init:
                break
            Wnew[i, qi] += S[i, qi]
            G[i, :] += S[i, qi] * P[qi, :]
            S[i, :] = np.maximum(0.0, W[i, :] - G[i, :] / (epsT + np.diag(P))) - W[i, :]
            D[i, :] = -G[i, :] * S[i, :] - 0.5 * np.diag(P) * S[i, :] ** 2
            qi = D[i, :].argmax()
    return np.maximum(W + Wnew, 0.0)


@pytest.mark.parametrize("shape", [(6, 8, 3), (40, 30, 6)])
def test_halfstep_matches_the_per_row_oracle(shape):
    p, n, k = shape
    X, W, H = _problem(p, n, k)
    got = tg._halfstep(*_t(X, W, H.T), 1e-3)
    np.testing.assert_allclose(got.numpy(), _oracle(X, W, H.T, 1e-3), atol=1e-12, rtol=0)


@pytest.mark.parametrize("reg", [dict(), dict(lambda_w=0.02, lambda_h=0.01)])
def test_six_iterations_match_jax(reg):
    X, W, H = _problem()
    rj = nmf_tpu.solve(nmf_tpu.GreedyCD(maxiter=6, tol=1e-30, **reg),
                       jnp.asarray(X), jnp.asarray(W), jnp.asarray(H), trace=True)
    Wt, Ht = _t(W, H)
    rt = nt.solve(nt.GreedyCD(maxiter=6, tol=1e-30, **reg), torch.from_numpy(X),
                  Wt, Ht, trace=True, device="cpu")
    assert rt.niters == rj.niters == 6 and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-8)
    np.testing.assert_allclose(rt.trace.objvalue.numpy(), np.asarray(rj.trace.objvalue), rtol=1e-8)
    # the caller's factors are not modified
    assert torch.equal(Wt, torch.from_numpy(W)) and torch.equal(Ht, torch.from_numpy(H))


def test_solve_stops_at_the_same_iteration_as_jax():
    X, W, H = _problem()
    rj = nmf_tpu.solve(nmf_tpu.GreedyCD(maxiter=200, tol=1e-3),
                       jnp.asarray(X), jnp.asarray(W), jnp.asarray(H))
    rt = nt.solve(nt.GreedyCD(maxiter=200, tol=1e-3), *_t(X, W, H), device="cpu")
    assert rt.converged and rj.converged and rt.niters == rj.niters < 200
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-8)


def test_objective_carries_both_l1_terms():
    X, W, H = _problem()
    upd = nt.GreedyCD(lambda_w=0.3, lambda_h=0.7)
    got = float(tg._objective(upd, (), *_t(X, W, H)))
    want = 0.5 * ((X - W @ H) ** 2).sum() + 0.3 * np.abs(W).sum() + 0.7 * np.abs(H).sum()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    ref = float(jg._objective(nmf_tpu.GreedyCD(lambda_w=0.3, lambda_h=0.7), (),
                              jnp.asarray(X), jnp.asarray(W), jnp.asarray(H)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_update_H_false_keeps_H():
    X, W, H = _problem()
    res = nt.solve(nt.GreedyCD(maxiter=3, tol=1e-30, update_H=False), *_t(X, W, H),
                   device="cpu")
    assert torch.equal(res.H, torch.from_numpy(H))
    ref = nmf_tpu.solve(nmf_tpu.GreedyCD(maxiter=3, tol=1e-30, update_H=False),
                        jnp.asarray(X), jnp.asarray(W), jnp.asarray(H))
    np.testing.assert_allclose(res.W.numpy(), np.asarray(ref.W), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(maxiter=1), dict(tol=0.0), dict(tol=-1.0),
                                dict(lambda_w=-1.0), dict(lambda_h=-0.5)])
def test_validation_errors_match_jax(kw):
    with pytest.raises(ValueError):
        nt.GreedyCD(**kw)
    with pytest.raises(ValueError):
        nmf_tpu.GreedyCD(**kw)


def test_options_resolve_and_register_like_jax():
    for dtype, tdtype in ((np.float32, torch.float32), (np.float64, torch.float64)):
        assert nt.GreedyCD()._resolved(tdtype)[1] == nmf_tpu.GreedyCD()._resolved(dtype)[1]
    assert nt.GreedyCD(tol=0.25)._resolved(torch.float32)[1] == 0.25
    assert tcommon._impl_for(nt.GreedyCD()).renumber_safe is True
    ref = nmf_tpu.GreedyCD(maxiter=7, tol=0.5, lambda_w=0.1, update_H=False)
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    assert convert.solver_from_fields("GreedyCD", fields) == nt.GreedyCD(
        maxiter=7, tol=0.5, lambda_w=0.1, update_H=False)
    pj = {f.name: f.default for f in dataclasses.fields(nmf_tpu.GreedyCD)}
    pt = {f.name: f.default for f in dataclasses.fields(nt.GreedyCD)}
    assert pj == pt


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("reg", [(0.0, 0.0), (1e-5, 1e-5)])
def test_greedycd_recovery(dtype, reg):
    rng = np.random.default_rng(21)
    X, Wg, Hg = laurberg6x3(dtype(0.3), dtype)
    W = (Wg + rng.random(Wg.shape) * 0.1).astype(dtype)
    res = nt.solve(nt.GreedyCD(maxiter=1000, tol=1e-9, lambda_w=reg[0], lambda_h=reg[1]),
                   *_t(X, W, Hg), device="cpu")
    Wr, Hr = res.W.numpy(), res.H.numpy()
    assert (Wr >= 0).all() and (Hr >= 0).all()
    assert not np.isnan(Wr).any() and not np.isnan(Hr).any()
    assert np.allclose(X, Wr @ Hr, atol=1e-3)


# ---------------------------------------------------------------------------
# the front door


def test_nnmf_greedycd_matches_jax():
    X, W, H = _problem()
    kw = dict(alg="greedycd", init="custom", W0=W, H0=H, maxiter=5, tol=1e-30)
    rj = nmf_tpu.nnmf(jnp.asarray(X), 5, **kw)
    rt = nt.nnmf(X, 5, device="cpu", **kw)
    assert rt.niters == rj.niters == 5
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-8)


def test_nnmf_greedycd_dispatch_and_random_init(monkeypatch):
    from nmf_tpu_torch.models import interface

    X = _problem(dtype=np.float32)[0]
    a = nt.nnmf(X, 4, alg="greedycd", init="random", maxiter=3, seed=2, device="cpu")
    b = nt.nnmf(X, 4, alg="greedycd", init="random", maxiter=3, seed=2, device="cpu")
    assert a == b and a.niters == 3 and bool((a.W >= 0).all())
    seen = {}
    monkeypatch.setattr(interface, "solve_replicates", lambda alginst, X, W, H, **kw: (
        seen.update(alg=alginst), nt.Result(W, H, 0, False, 0.0))[1])
    with pytest.warns(UserWarning, match="Only W will be updated"):
        nt.nnmf(X, 4, alg="greedycd", init="random", maxiter=17, tol=0.5,
                update_H=False, device="cpu")
    g = seen["alg"]
    assert type(g) is nt.GreedyCD
    assert (g.maxiter, g.tol, g.update_H, g.lambda_w, g.lambda_h) == (17, 0.5, False, 0.0, 0.0)


# ---------------------------------------------------------------------------
# how the rows are batched never changes a row's result


def test_argmax_returns_the_first_maximum_like_jax():
    """GreedyCD's schedule hangs on which of two equal scores is taken."""
    D = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, -1.0, 5.0, 5.0]])
    want = [1, 0, 2]
    assert torch.from_numpy(D).argmax(dim=1).tolist() == want
    assert jnp.argmax(jnp.asarray(D), axis=1).tolist() == want
    assert D.argmax(axis=1).tolist() == want


def _row_by_row(W, G, S, D, P, denom, Pdiag, threshold, max_inner):
    """Every row alone, one coordinate step after the other."""
    delta = torch.zeros_like(W)
    for i in range(W.shape[0]):
        w, g, s, d = W[i], G[i].clone(), S[i], D[i]
        qi = int(d.argmax())
        for _ in range(max_inner):
            if not bool(d[qi] >= threshold):
                break
            step = s[qi]
            delta[i, qi] += step
            g = g + step * P[qi]
            s, d = tg._scores(w, g, denom, Pdiag)
            qi = int(d.argmax())
    return delta


def _scoring(p=300, n=70, k=5, seed=11, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = np.abs(rng.random((p, k)) @ rng.random((k, n))).astype(dtype)
    W, Ht = _t(rng.random((p, k)).astype(dtype), rng.random((n, k)).astype(dtype))
    P = Ht.T @ Ht
    Pdiag = torch.diagonal(P)
    denom = np.finfo(dtype).eps + Pdiag
    G = W @ P - torch.from_numpy(X) @ Ht
    S, D = tg._scores(W, G, denom, Pdiag)
    threshold = 0.001 * D.max().clamp_min(-1.0)
    return W, G, S, D, P, denom, Pdiag, threshold, k * k


@pytest.mark.parametrize("knobs", [
    dict(off_rows=1 << 30),
    dict(off_rows=1, min=16),
    dict(off_rows=1, min=4, shrink=2),
    dict(off_rows=1, min=1, shrink=3),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_greedy_rows_equal_the_row_by_row_loop_bit_for_bit(cascade, knobs, dtype):
    args = _scoring(dtype=dtype)
    want = _row_by_row(*args)
    assert int((want != 0).sum()) > args[0].shape[0]  # rows do step
    cascade(**knobs)
    W, G, *rest = args
    got = tg._greedy_rows(W, G.clone(), *rest)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cascade_runs_several_levels(cascade, monkeypatch):
    """With a small floor the rows are gathered into smaller buffers several
    times, and the buffers shrink."""
    sizes = []
    step = tg._masked_step
    monkeypatch.setattr(tg, "_masked_step", lambda W, *a: (sizes.append(W.shape[0]), step(W, *a))[1])
    cascade(off_rows=1, min=4, shrink=2)
    W, G, *rest = _scoring()
    tg._greedy_rows(W, G.clone(), *rest)
    levels = sorted(set(sizes), reverse=True)
    assert len(levels) >= 4 and levels[0] == W.shape[0] and sizes == sorted(sizes, reverse=True)
    sizes.clear()
    cascade(off_rows=1 << 30)
    tg._greedy_rows(W, G.clone(), *rest)
    assert set(sizes) == {W.shape[0]}


@pytest.mark.parametrize("knobs", [
    dict(off_rows=1, min=16),
    dict(off_rows=1, min=16, shrink=2),
    dict(slab_rows=256, off_rows=128, min=32),  # 4 slabs, the last overlaps
    dict(slab_rows=256, off_rows=1 << 30),
    dict(slab_rows=100, off_rows=1, min=1),
])
def test_cascade_and_slab_solves_are_bit_identical_to_the_plain_loop(cascade, knobs):
    rng = np.random.default_rng(11)
    p, n, k = 900, 140, 7
    Xd = np.maximum(rng.random((p, k)) @ rng.random((k, n)), 0).astype(np.float32)
    X, W0, H0 = _t(Xd, rng.random((p, k)).astype(np.float32),
                   rng.random((k, n)).astype(np.float32))
    alg = nt.GreedyCD(maxiter=5, tol=1e-30)
    cascade(off_rows=1 << 30, slab_rows=1 << 30)
    plain = nt.solve(alg, X, W0, H0, device="cpu")
    cascade(**knobs)
    got = nt.solve(alg, X, W0, H0, device="cpu")
    assert got.niters == plain.niters == 5
    np.testing.assert_array_equal(got.W.numpy(), plain.W.numpy())
    np.testing.assert_array_equal(got.H.numpy(), plain.H.numpy())
    assert got.objvalue == plain.objvalue


def test_cascade_constants_and_setter(cascade):
    assert config.greedycd_cascade == dict(shrink=4, min=128, off_rows=4096,
                                           slab_rows=524_288)
    ref = nmf_tpu.config.greedycd_cascade
    assert {k: ref[k] for k in config.greedycd_cascade} == config.greedycd_cascade
    cascade(shrink=2, slab_rows=10)
    assert config.greedycd_cascade == dict(shrink=2, min=128, off_rows=4096, slab_rows=10)
    cascade()  # nothing given, nothing changed
    assert config.greedycd_cascade["shrink"] == 2
    for bad in (dict(shrink=1), dict(min=0), dict(off_rows=0), dict(slab_rows=-3),
                dict(shrink=2.0), dict(min=True)):
        with pytest.raises(ValueError, match="must be an int >="):
            cascade(**bad)
    # a refused call changes nothing
    with pytest.raises(ValueError):
        cascade(min=7, shrink=1)
    assert config.greedycd_cascade["min"] == 128
