"""The ported path as a whole against the JAX package: five Fast-HALS
iterations on the tiled store through ``nnmf`` and through ``solve``, the
traced and verbose paths, the resumable loop, and the front door's validation.

Tolerances: ``rtol=1e-4, atol=1e-6`` on the factors and ``rtol=1e-4`` on the
objective — the float32 products are summed in another order on each side and
the difference is fed back through five sweeps of k sequential column
updates."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models.coorddesc import CoordinateDescent as JaxCD
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.ops.sparse_format import build_tiled

from torch_parity import (BUILD, QUAD_BUILD, coo_of, four_class_matrix,
                          three_class_matrix)

K = 6
F32 = dict(rtol=1e-4, atol=1e-6)
# for runs of more sweeps, or of the same package over another X layout (a
# dense product instead of the three-part sum): small entries near the clamp
# carry the products' absolute error
F32_LONG = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def problem():
    Xd = three_class_matrix(0)
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(21)
    W0 = rng.random((Xd.shape[0], K), dtype=np.float32)
    H0 = rng.random((K, Xd.shape[1]), dtype=np.float32)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    return Xd, Xj, Xt, W0, H0


def _same_result(rt, rj, tol=F32):
    assert rt.niters == rj.niters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), **tol)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), **tol)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-4)


@pytest.mark.parametrize("trace", [False, True])
def test_nnmf_five_hals_iterations_on_the_tiled_store(problem, trace):
    _, Xj, Xt, W0, H0 = problem
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, maxiter=5, tol=1e-30,
              trace=trace)
    rj = nmf_tpu.nnmf(Xj, K, **kw)
    rt = nt.nnmf(Xt, K, device="cpu", **kw)
    assert rt.niters == 5 and not rt.converged
    assert rt.W.dtype == torch.float32 and tuple(rt.W.shape) == W0.shape
    _same_result(rt, rj)
    if trace:
        for name in ("objvalue", "relchange"):
            got = getattr(rt.trace, name).numpy()
            assert got.shape == (5,)
            np.testing.assert_allclose(
                got, np.asarray(getattr(rj.trace, name)), rtol=1e-4
            )
        assert rt.trace.objvalue[-1] == pytest.approx(rt.objvalue, rel=1e-6)
    else:
        assert rt.trace is None


@pytest.mark.parametrize("reg", [dict(), dict(alpha=0.3, l1ratio=0.4)])
def test_solve_five_hals_iterations_on_the_tiled_store(problem, reg):
    _, Xj, Xt, W0, H0 = problem
    rj = nmf_tpu.solve(JaxCD(maxiter=5, tol=1e-30, **reg), Xj,
                       jnp.asarray(W0), jnp.asarray(H0))
    Wt, Ht = torch.from_numpy(W0), torch.from_numpy(H0)
    rt = nt.solve(nt.CoordinateDescent(maxiter=5, tol=1e-30, **reg), Xt, Wt, Ht,
                  device="cpu")
    _same_result(rt, rj)
    # the caller's factors are not modified
    assert torch.equal(Wt, torch.from_numpy(W0)) and torch.equal(Ht, torch.from_numpy(H0))


def test_solve_stops_at_the_same_iteration(problem):
    """A loose tolerance: both loops stop converged at the same count."""
    _, Xj, Xt, W0, H0 = problem
    rj = nmf_tpu.solve(JaxCD(maxiter=40, tol=0.05), Xj, jnp.asarray(W0), jnp.asarray(H0))
    rt = nt.solve(nt.CoordinateDescent(maxiter=40, tol=0.05), Xt,
                  torch.from_numpy(W0), torch.from_numpy(H0), device="cpu")
    assert rt.converged and 5 < rt.niters < 40
    _same_result(rt, rj, F32_LONG)


def test_tiled_and_dense_X_agree(problem):
    Xd, _, Xt, W0, H0 = problem
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, maxiter=5, tol=1e-30,
              device="cpu")
    a = nt.nnmf(Xt, K, **kw)
    b = nt.nnmf(Xd, K, **kw)
    np.testing.assert_allclose(a.W.numpy(), b.W.numpy(), **F32_LONG)
    np.testing.assert_allclose(a.H.numpy(), b.H.numpy(), **F32_LONG)
    # natural order (no renumbering) gives the same solve too
    r, c, v = coo_of(Xd)
    Xn = build_tiled(r, c, v, Xd.shape, device="cpu", order="natural", **BUILD)
    n = nt.nnmf(Xn, K, **kw)
    np.testing.assert_allclose(n.W.numpy(), a.W.numpy(), **F32_LONG)
    assert n.objvalue == pytest.approx(a.objvalue, rel=1e-4)


def test_resumable_loop_in_chunks_equals_one_run(problem):
    _, _, Xt, W0, H0 = problem
    upd, _ = nt.CoordinateDescent()._resolved(torch.float32)
    W, H = torch.from_numpy(W0), torch.from_numpy(H0)
    whole = tcommon._solve_while_from(
        upd, tcommon._prepare(upd, Xt, W, H), Xt, W, H, 0, 6, 1e-30
    )
    state = tcommon._prepare(upd, Xt, W, H)
    t = 0
    for bound in (2, 4, 6):
        W, H, state, t, conv, objv = tcommon._solve_while_from(
            upd, state, Xt, W, H, t, bound, 1e-30, with_objective=bound == 6
        )
        assert t == bound and not conv
        assert bound == 6 or bool(torch.isnan(objv))
    assert torch.equal(W, whole[0]) and torch.equal(H, whole[1])
    assert float(objv) == float(whole[5]) and whole[3] == 6


def test_verbose_prints_the_trace_table_and_gives_the_same_result(problem, capsys):
    _, _, Xt, W0, H0 = problem
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, maxiter=3, tol=1e-30,
              device="cpu")
    quiet = nt.nnmf(Xt, K, **kw)
    assert capsys.readouterr().out == ""
    loud = nt.nnmf(Xt, K, verbose=True, **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:2] == ["Iter", "Elapsed"] and len(lines) == 1 + 1 + 3
    assert [int(ln.split()[0]) for ln in lines[1:]] == [0, 1, 2, 3]
    assert torch.equal(loud.W, quiet.W) and torch.equal(loud.H, quiet.H)
    assert loud.niters == 3 and loud.objvalue == pytest.approx(quiet.objvalue, rel=1e-6)
    # the objective column falls
    objs = [float(ln.split()[2]) for ln in lines[1:]]
    assert all(b < a for a, b in zip(objs, objs[1:]))


def test_update_H_false_keeps_H(problem):
    _, _, Xt, W0, H0 = problem
    res = nt.nnmf(Xt, K, alg="cd", init="custom", W0=W0, H0=H0, maxiter=2,
                  tol=1e-30, update_H=False, device="cpu")
    assert torch.equal(res.H, torch.from_numpy(H0))
    assert not torch.equal(res.W, torch.from_numpy(W0))


def test_random_init_and_replicates(problem):
    _, _, Xt, _, _ = problem
    kw = dict(alg="cd", init="random", maxiter=3, tol=1e-30, device="cpu")
    a = nt.nnmf(Xt, K, seed=4, **kw)
    b = nt.nnmf(Xt, K, seed=4, **kw)
    c = nt.nnmf(Xt, K, seed=5, **kw)
    assert a == b and hash(a) == hash(b) and a != c
    g = nt.nnmf(Xt, K, generator=torch.Generator().manual_seed(9), **kw)
    assert g == nt.nnmf(Xt, K, generator=torch.Generator().manual_seed(9), **kw)
    # replicates keep the best of the sequential restarts
    best = nt.nnmf(Xt, K, seed=4, replicates=3, **kw)
    assert best.objvalue <= a.objvalue
    assert bool((best.W >= 0).all()) and bool((best.H >= 0).all())


# ---------------------------------------------------------------------------
# the front door's rules: same errors and warnings as the JAX package


def _small():
    rng = np.random.default_rng(0)
    return rng.random((12, 9)).astype(np.float32)


BAD_CALLS = [
    # (kwargs, error, message)
    (dict(k=10), ValueError, "should not exceed"),
    (dict(replicates=0), ValueError, "replicates must be positive"),
    (dict(init="custom"), ValueError, "set W0 and H0"),
    (dict(init="custom", W0=np.ones((12, 3)), H0=None), ValueError, "set W0 and H0"),
    (dict(init="custom", W0=-np.ones((12, 3)), H0=np.ones((3, 9))), ValueError,
     "W0 must be non-negative"),
    (dict(init="custom", W0=np.ones((11, 3)), H0=np.ones((3, 9))), ValueError,
     "Invalid size for W0"),
    (dict(init="custom", W0=np.ones((12, 3)), H0=-np.ones((3, 9))), ValueError,
     "H0 must be non-negative"),
    (dict(init="custom", W0=np.ones((12, 3)), H0=np.ones((3, 8))), ValueError,
     "Invalid size for H0"),
    (dict(init="bogus"), ValueError, "Invalid value for init"),
    (dict(alg="bogus"), ValueError, "Invalid algorithm"),
    (dict(alg="spa", init="random"), ValueError, "use :spa instead"),
]


@pytest.mark.parametrize("kw, exc, msg", BAD_CALLS)
def test_nnmf_validation_errors_match_jax(kw, exc, msg):
    kw = dict(dict(k=3, alg="cd", init="random"), **kw)
    k = kw.pop("k")
    with pytest.raises(exc, match=msg):
        nt.nnmf(_small(), k, device="cpu", **kw)
    with pytest.raises(exc, match=msg):
        nmf_tpu.nnmf(jnp.asarray(_small()), k, **kw)


def test_nnmf_rejects_negative_X():
    X = _small()
    X[3, 4] = -1.0
    for call in (lambda: nt.nnmf(X, 3, alg="cd", init="random", device="cpu"),
                 lambda: nmf_tpu.nnmf(jnp.asarray(X), 3, alg="cd", init="random")):
        with pytest.raises(ValueError, match="X must be non-negative"):
            call()
    r, c = np.nonzero(X)
    neg = build_tiled(r, c, X[r, c], X.shape, device="cpu")
    with pytest.raises(ValueError, match="X must be non-negative"):
        nt.nnmf(neg, 3, alg="cd", init="random", device="cpu")


def test_nnmf_warnings_match_jax():
    X = _small()
    kw = dict(alg="cd", init="random", maxiter=1)
    for call in (lambda **k: nt.nnmf(X, 3, device="cpu", **k),
                 lambda **k: nmf_tpu.nnmf(jnp.asarray(X), 3, **k)):
        with pytest.warns(UserWarning, match="Only W will be updated"):
            call(update_H=False, **kw)
        with pytest.warns(UserWarning, match="Ignore W0 and H0"):
            call(W0=np.ones((12, 3), np.float32), **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            call(**kw)


@pytest.mark.parametrize("alg", ["projals", "alspgrad"])
def test_unported_alg_says_so(alg):
    with pytest.raises(NotImplementedError, match=f"alg='{alg}' is not ported yet"):
        nt.nnmf(_small(), 3, alg=alg, init="random", device="cpu")


@pytest.mark.parametrize("init", ["nndsvd", "nndsvda", "nndsvdar", "spa"])
def test_unported_init_says_so(init, monkeypatch):
    """``spa`` is not ported and says so; the NNDSVD inits are, and dispatch
    to ``nndsvd`` with the JAX package's variant and ``initdata``."""
    from nmf_tpu_torch.models import interface

    if init == "spa":
        with pytest.raises(NotImplementedError, match=f"init='{init}' is not ported yet"):
            nt.nnmf(_small(), 3, alg="spa", init=init, device="cpu")
        return
    seen = {}
    real = interface.nndsvd

    def spy(X, k, **kw):
        seen.update(kw)
        return real(X, k, **kw)

    monkeypatch.setattr(interface, "nndsvd", spy)
    data = (np.ones((12, 3)), np.ones(3), np.ones((9, 3)))
    nt.nnmf(_small(), 3, alg="cd", init=init, initdata=data, maxiter=1, device="cpu")
    assert seen["variant"] == {"nndsvd": "std", "nndsvda": "a", "nndsvdar": "ar"}[init]
    assert seen["initdata"] is data
    assert seen["device"] == torch.device("cpu")


@pytest.mark.parametrize("alg, cls, obj", [
    ("cd", nt.CoordinateDescent, None),
    ("greedycd", nt.GreedyCD, None),
    ("multmse", nt.MultUpdate, "mse"),
    ("multdiv", nt.MultUpdate, "div"),
])
def test_ported_alg_dispatches_to_its_solver(alg, cls, obj, monkeypatch):
    """``nnmf`` builds the options object the JAX package builds for the same
    ``alg``: class, objective, and the front door's maxiter / tol / update_H."""
    from nmf_tpu_torch.models import interface

    seen = {}

    def spy(alginst, X, W, H, **kw):
        seen["alg"] = alginst
        return nt.Result(W, H, 0, False, 0.0)

    monkeypatch.setattr(interface, "solve_replicates", spy)
    with pytest.warns(UserWarning, match="Only W will be updated"):
        nt.nnmf(_small(), 3, alg=alg, init="random", maxiter=17, tol=0.5,
                update_H=False, device="cpu")
    a = seen["alg"]
    assert type(a) is cls and (a.maxiter, a.tol, a.update_H) == (17, 0.5, False)
    assert obj is None or a.obj == obj


def test_defaults_are_the_jax_packages_and_not_ported_yet():
    """The front door's defaults are the JAX package's, and ``nnmf(X, k)``
    runs with all of them (NNDSVD-ar over a randomized SVD, GreedyCD)."""
    import inspect

    pj = inspect.signature(nmf_tpu.nnmf).parameters
    pt = inspect.signature(nt.nnmf).parameters
    for name in ("init", "initdata", "alg", "maxiter", "tol", "replicates", "W0",
                 "H0", "update_H", "verbose", "seed", "trace"):
        assert pt[name].default == pj[name].default, name
        assert pt[name].kind == pj[name].kind
    assert pt["device"].default == "cuda"
    X = _small()
    res = nt.nnmf(X, 3, device="cpu")
    assert tuple(res.W.shape) == (12, 3) and tuple(res.H.shape) == (3, 9)
    assert 1 <= res.niters <= 100 and bool((res.W >= 0).all() and (res.H >= 0).all())
    rel = float(torch.linalg.norm(torch.as_tensor(X) - res.W @ res.H)
                / torch.linalg.norm(torch.as_tensor(X)))
    assert rel < 0.5
    # the same seed gives the same run
    again = nt.nnmf(X, 3, device="cpu")
    assert torch.equal(again.W, res.W) and again.niters == res.niters


@pytest.mark.parametrize("alg", ["cd", "multmse", "multdiv"])
@pytest.mark.parametrize("entry", ["nnmf", "solve"])
def test_strided_dense_x_is_settled_at_the_entry_point(alg, entry, monkeypatch):
    """A transposed view of X solves like its row-major copy, and the solver
    below the entry point is handed a contiguous X (the dense kernels read
    it row-major)."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.random((9, 14), dtype=np.float32))
    view, copy = A.T, A.T.contiguous()
    assert not view.is_contiguous()
    W0 = torch.from_numpy(rng.random((14, 3), dtype=np.float32))
    H0 = torch.from_numpy(rng.random((3, 9), dtype=np.float32))
    inst = (nt.CoordinateDescent(maxiter=4, shuffle=False) if alg == "cd"
            else nt.MultUpdate(obj=alg[4:], maxiter=4))

    def run(X):
        if entry == "nnmf":
            return nt.nnmf(X, 3, alg=alg, init="custom", W0=W0, H0=H0,
                           maxiter=4, device="cpu")
        return nt.solve(inst, X, W0, H0, device="cpu")

    seen = []
    inner = type(inst)._solve
    monkeypatch.setattr(type(inst), "_solve", lambda self, X, *a: (
        seen.append(X.is_contiguous()), inner(self, X, *a))[1])
    a, b = run(view), run(copy)
    assert seen == [True, True]
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert a.objvalue == b.objvalue


def test_solve_checks_where_the_operands_live(problem):
    _, _, Xt, W0, H0 = problem
    with pytest.raises(TypeError, match="No solver registered"):
        tcommon.nmf_skeleton(object(), Xt, torch.from_numpy(W0),
                             torch.from_numpy(H0), 1, False, 1e-3)
    with pytest.raises(ValueError, match="inconsistent"):
        nt.solve(nt.CoordinateDescent(maxiter=1), Xt, torch.from_numpy(W0),
                 torch.from_numpy(H0[:, :-1].copy()), device="cpu")


# ---------------------------------------------------------------------------
# randinit


def test_randinit():
    X = torch.zeros(50, 40, dtype=torch.float64)
    W, H = nt.randinit(X, 5, generator=torch.Generator().manual_seed(3), device="cpu")
    assert tuple(W.shape) == (50, 5) and tuple(H.shape) == (5, 40)
    assert W.dtype == H.dtype == torch.float64
    for A in (W, H):
        assert float(A.min()) >= 0.0 and float(A.max()) < 1.0
    W2, H2 = nt.randinit(X, 5, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(W, W2) and torch.equal(H, H2)
    W3, _ = nt.randinit(X, 5, generator=torch.Generator().manual_seed(4), device="cpu")
    assert not torch.equal(W, W3)
    Wn, Hz = nt.randinit((50, 40), 5, normalize=True, zeroh=True, device="cpu")
    assert Wn.dtype == torch.float32
    np.testing.assert_allclose(Wn.sum(0).numpy(), np.ones(5), rtol=1e-5)
    assert not Hz.any() and tuple(Hz.shape) == (5, 40)


# ---------------------------------------------------------------------------
# the quad-tail store: HALS, GreedyCD and the divergence updates against the
# JAX package, whose products go through its quad kernels in interpret mode


@pytest.fixture(scope="module")
def quad_problem():
    Xd = four_class_matrix(0)
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(23)
    W0 = rng.random((Xd.shape[0], K), dtype=np.float32)
    H0 = rng.random((K, Xd.shape[1]), dtype=np.float32)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **QUAD_BUILD)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **QUAD_BUILD)
    assert Xt.fwd.n_qchunks and Xt.fwd.n_dblocks and Xt.fwd.n_coo
    return Xd, Xj, Xt, W0, H0


@pytest.mark.parametrize("alg", ["cd", "multdiv", "multmse"])
def test_nnmf_on_the_quad_store_matches_jax(quad_problem, alg):
    _, Xj, Xt, W0, H0 = quad_problem
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=4, tol=1e-30)
    rj = nmf_tpu.nnmf(Xj, K, **kw)
    rt = nt.nnmf(Xt, K, device="cpu", **kw)
    assert rt.niters == 4 and not rt.converged
    _same_result(rt, rj, F32_LONG)


def test_greedycd_halfsteps_on_the_quad_store_match_jax(quad_problem):
    """GreedyCD picks coordinates by comparing float32 scores, so a run of
    sweeps can part ways on a tie; parity on a tiled float32 store is held
    per half-step and per objective, from the same factors: ``rtol=2e-4,
    atol=1e-4``, the JAX package's own limits for this solver on a quad
    store."""
    import jax

    from nmf_tpu.models import greedycd as jg
    from nmf_tpu_torch.models import greedycd as tg

    _, Xj, Xt, W0, H0 = quad_problem
    tol = dict(rtol=2e-4, atol=1e-4)
    Wt, Ht = torch.from_numpy(W0), torch.from_numpy(H0)
    jhalf = jax.jit(jg._halfstep)
    Wj = np.asarray(jhalf(Xj, jnp.asarray(W0), jnp.asarray(H0.T), 0.0))
    Wn = tg._halfstep(Xt, Wt, Ht.T, 0.0)
    np.testing.assert_allclose(Wn.numpy(), Wj, **tol)
    assert not torch.equal(Wn, Wt) and bool((Wn >= 0).all())
    # the H step, through the transposed store, from the same new W
    Hj = np.asarray(jhalf(Xj.transpose(), jnp.asarray(H0.T), jnp.asarray(Wj), 0.01))
    Hn = tg._halfstep(Xt.transpose(), Ht.T, torch.from_numpy(Wj.copy()), 0.01)
    np.testing.assert_allclose(Hn.numpy(), Hj, **tol)
    upd = nt.GreedyCD(lambda_w=0.1, lambda_h=0.2)
    ref = nmf_tpu.GreedyCD(lambda_w=0.1, lambda_h=0.2)
    got = float(tg._objective(upd, (), Xt, Wn, Hn.T))
    want = float(jax.jit(jg._objective)(ref, (), Xj, jnp.asarray(Wn.numpy()),
                                        jnp.asarray(Hn.numpy().T)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_greedycd_solve_on_the_quad_store(quad_problem):
    """A whole solve through the front door: same iteration count and
    objective (``rtol=1e-4``) as the JAX package and as the port on the same
    matrix held dense.  The factors are held in norm, ``1e-3`` of ``||W||``:
    after three sweeps a few entries of a few rows have taken another
    coordinate on a near-tie of float32 scores (2 of 4200 entries moved by
    5e-4 here), which an entrywise limit would call a failure."""

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)

    Xd, Xj, Xt, W0, H0 = quad_problem
    kw = dict(alg="greedycd", init="custom", W0=W0, H0=H0, maxiter=3, tol=1e-30)
    rj = nmf_tpu.nnmf(Xj, K, **kw)
    rt = nt.nnmf(Xt, K, device="cpu", **kw)
    assert rt.niters == rj.niters == 3
    same(rt.W.numpy(), rj.W)
    same(rt.H.numpy(), rj.H)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-4)
    rd = nt.nnmf(Xd, K, device="cpu", **kw)
    same(rt.W.numpy(), rd.W.numpy())
    np.testing.assert_allclose(rt.objvalue, rd.objvalue, rtol=1e-4)
    # objective falls from sweep to sweep
    tr = nt.nnmf(Xt, K, device="cpu", trace=True, **kw).trace.objvalue.tolist()
    assert tr[0] > tr[1] > tr[2]


@pytest.mark.parametrize("alg", ["cd", "greedycd"])
def test_slimmed_quad_store_solves_the_same(quad_problem, alg):
    _, _, Xt, W0, H0 = quad_problem
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=3, tol=1e-30, device="cpu")
    a, b = nt.nnmf(Xt, K, **kw), nt.nnmf(Xt.slim(), K, **kw)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H) and a.objvalue == b.objvalue
