"""A general sparse X (a torch sparse tensor of any layout, held as
``SparseCSR``) in the PyTorch build: the ``matops`` seam against the JAX
package's BCOO branch (float64, ``rtol=1e-12``), every solver sparse against
dense with the JAX package's tolerances (``tests/test_sparse.py``:
``rtol=1e-7, atol=1e-9`` and the same iteration count), the initialisers,
``nnmf`` end to end, and ``from_bcoo`` against ``build_tiled``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import nmf_tpu as J
from nmf_tpu.ops import matops as jm
import nmf_tpu_torch as nt
from nmf_tpu_torch import convert
from nmf_tpu_torch.ops import matops as tm
from nmf_tpu_torch.ops.sparse_format import SparseCSR, build_tiled, from_bcoo

F64 = dict(rtol=1e-12, atol=1e-13)
SOLVE_TOL = dict(rtol=1e-7, atol=1e-9)


def make_sparse_problem(seed=7, p=30, n=40, k=4, density=0.3):
    """The JAX package's sparse problem (``tests/test_sparse.py``)."""
    rng = np.random.default_rng(seed)
    X = rng.random((p, n)) * (rng.random((p, n)) < density)
    # no empty rows or columns
    X[np.arange(p), rng.integers(0, n, p)] += 0.5
    X[rng.integers(0, p, n), np.arange(n)] += 0.5
    return X, rng.random((p, k)), rng.random((k, n))


def torch_sparse(X, form):
    """X as a torch sparse tensor: ``coo``, ``csr``, or ``coo_dups`` (every
    entry split into two stored parts, out of order, which the build sums)."""
    Xt = torch.from_numpy(X)
    if form == "csr":
        return Xt.to_sparse_csr()
    if form == "coo":
        return Xt.to_sparse_coo()
    r, c = np.nonzero(X)
    v = X[r, c]
    order = np.random.default_rng(1).permutation(2 * len(v))
    idx = np.concatenate([np.stack([r, c])] * 2, axis=1)[:, order]
    vals = np.concatenate([0.25 * v, 0.75 * v])[order]
    return torch.sparse_coo_tensor(torch.from_numpy(idx), torch.from_numpy(vals), X.shape)


FORMS = ["coo", "csr", "coo_dups"]


@pytest.mark.parametrize("form", FORMS)
def test_matops_match_the_jax_bcoo_branch(form):
    X, W, H = make_sparse_problem()
    Xs = tm.as_operand(torch_sparse(X, form))
    Xb = jsparse.BCOO.fromdense(jnp.asarray(X))
    assert isinstance(Xs, SparseCSR) and tm.is_sparse(Xs) and tm.is_general(Xs)
    assert not tm.is_tiled(Xs) and not tm.is_dense_f32_on_card(Xs)
    assert Xs.shape == X.shape and Xs.dtype == torch.float64 and Xs.nnz == Xb.nse
    assert tm.device_probe(Xs).device == torch.device("cpu")
    rng = np.random.default_rng(0)
    D, Dt = rng.random((X.shape[1], 5)), rng.random((6, X.shape[0]))
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)

    def eq(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **F64)

    eq(tm.mm(Xs, torch.from_numpy(D)), jm.mm(Xb, jnp.asarray(D)))
    eq(tm.mtm(torch.from_numpy(Dt), Xs), jm.mtm(jnp.asarray(Dt), Xb))
    eq(tm.sddmm(Wt, Ht, Xs), jm.sddmm(jnp.asarray(W), jnp.asarray(H), Xb))
    eq(tm.nnz_values(Xs), jm.nnz_values(Xb))
    np.testing.assert_array_equal(tm.col_indices(Xs).numpy(), np.asarray(jm.col_indices(Xb)))
    for name in ("sq_norm", "total_sum", "mean"):
        eq(float(getattr(tm, name)(Xs)), float(getattr(jm, name)(Xb)))
    eq(tm.colsums(Xs), jm.colsums(Xb))
    eq(tm.rowsums(Xs), jm.rowsums(Xb))
    assert bool(tm.all_nonneg(Xs)) and bool(jm.all_nonneg(Xb))
    # the transpose swaps the two orientations without a copy
    Xst = tm.transpose(Xs)
    assert Xst.fwd is Xs.bwd and Xst.bwd is Xs.fwd and Xst.shape == X.shape[::-1]
    eq(tm.mm(Xst, torch.from_numpy(Dt.T)), jm.mm(jm.transpose(Xb), jnp.asarray(Dt.T)))
    eq(tm.nnz_values(Xst), jm.nnz_values(jsparse.BCOO.fromdense(jnp.asarray(X.T))))
    eq(tm.rowsums(Xst), jm.colsums(Xb))
    # new values refresh both orientations and the stats
    new = tm.nnz_values(Xs) * 2 - 0.1
    Xn = tm.scale_values(Xs, new)
    Xbn = jm.scale_values(Xb, jnp.asarray(new.numpy()))
    eq(tm.mm(Xn, torch.from_numpy(D)), jm.mm(Xbn, jnp.asarray(D)))
    eq(tm.mtm(torch.from_numpy(Dt), Xn), jm.mtm(jnp.asarray(Dt), Xbn))
    eq(float(tm.sq_norm(Xn)), float(jm.sq_norm(Xbn)))
    assert bool(tm.all_nonneg(Xn)) == bool(jm.all_nonneg(Xbn)) == bool((new >= 0).all())
    # any k: the column slabs of the products
    Dw = rng.random((X.shape[1], 460))
    eq(tm.mm(Xs, torch.from_numpy(Dw)), X @ Dw)


def test_a_torch_sparse_tensor_round_trips_and_keeps_its_dtype():
    X, _, _ = make_sparse_problem()
    for dtype in (torch.float32, torch.float64):
        S = torch.from_numpy(X).to(dtype).to_sparse_csr()
        A = SparseCSR.from_torch_sparse(S)
        assert A.dtype == dtype and A.stats.dtype == dtype
        for side, want in ((A.fwd, S.to_dense()), (A.transpose().fwd, S.to_dense().T)):
            got = torch.sparse_csr_tensor(side.crow, side.col, side.val, want.shape)
            assert torch.equal(got.to_dense(), want)
            assert torch.equal(side.row.long(), torch.repeat_interleave(
                torch.arange(want.shape[0]), side.crow.diff().long()))
        assert torch.equal(A.fwd.crow.long(), S.crow_indices())
    # a CSR tensor whose rows list their columns out of order is sorted
    crow = torch.tensor([0, 3, 4])
    col = torch.tensor([2, 0, 1, 0])
    vals = torch.tensor([3.0, 1.0, 2.0, 4.0])
    A = SparseCSR.from_torch_sparse(torch.sparse_csr_tensor(crow, col, vals, (2, 3)))
    assert A.col_idx.tolist() == [0, 1, 2, 0] and A.values.tolist() == [1, 2, 3, 4]
    # other layouts are taken too; dense entries and batches are refused
    r, c = np.nonzero(X)
    assert torch.equal(SparseCSR.from_torch_sparse(
        torch.from_numpy(X).to_sparse_csc()).values, torch.from_numpy(X[r, c]))
    with pytest.raises(ValueError, match="2-d"):
        SparseCSR.from_torch_sparse(torch.ones(2, 3, 2).to_sparse(2))
    with pytest.raises(TypeError, match="sparse"):
        SparseCSR.from_torch_sparse(torch.ones(2, 3))


SOLVERS = [
    nt.MultUpdate(obj="mse", maxiter=25),
    nt.MultUpdate(obj="div", maxiter=25),
    nt.ProjectedALS(maxiter=25),
    nt.CoordinateDescent(maxiter=25),
    nt.GreedyCD(maxiter=25),
    nt.ALSPGrad(maxiter=5),
]


@pytest.mark.parametrize("alg", SOLVERS,
                         ids=lambda a: type(a).__name__ + getattr(a, "obj", ""))
def test_sparse_matches_dense(alg):
    X, W0, H0 = make_sparse_problem()
    W0, H0 = torch.from_numpy(W0), torch.from_numpy(H0)
    dense = nt.solve(alg, torch.from_numpy(X), W0, H0, device="cpu")
    sp = nt.solve(alg, torch_sparse(X, "csr"), W0, H0, device="cpu")
    assert sp.niters == dense.niters
    np.testing.assert_allclose(sp.W.numpy(), dense.W.numpy(), **SOLVE_TOL)
    np.testing.assert_allclose(sp.H.numpy(), dense.H.numpy(), **SOLVE_TOL)
    np.testing.assert_allclose(sp.objvalue, dense.objvalue, rtol=1e-7)


def test_sparse_solve_matches_the_jax_bcoo_solve():
    X, W0, H0 = make_sparse_problem()
    Xb = jsparse.BCOO.fromdense(jnp.asarray(X))
    rj = J.solve(J.MultUpdate(obj="div", maxiter=25), Xb, jnp.asarray(W0), jnp.asarray(H0))
    rt = nt.solve(nt.MultUpdate(obj="div", maxiter=25), torch_sparse(X, "coo"),
                  torch.from_numpy(W0), torch.from_numpy(H0), device="cpu")
    assert rt.niters == rj.niters
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, rtol=1e-10)


def test_sparse_spa_matches_dense():
    W, H = nt.separable_data(25, 18, 3, generator=torch.Generator().manual_seed(2),
                             dtype=torch.float64, device="cpu")
    X = (W @ H).numpy()
    X = X * (X > 0.02)
    wd, hd = nt.spa(torch.from_numpy(X), 3, device="cpu")
    ws, hs = nt.spa(torch_sparse(X, "coo"), 3, device="cpu")
    np.testing.assert_allclose(ws.numpy(), wd.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(hs.numpy(), hd.numpy(), rtol=1e-6, atol=1e-9)


def test_sparse_nndsvd_and_rsvd():
    X, _, _ = make_sparse_problem(p=40, n=30)
    Xs, Xd = torch_sparse(X, "csr"), torch.from_numpy(X)
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    s_sp = nt.rsvd(Xs, 5, generator=gen(3), device="cpu")[1]
    s_d = nt.rsvd(Xd, 5, generator=gen(3), device="cpu")[1]
    np.testing.assert_allclose(s_sp.numpy(), s_d.numpy(), rtol=1e-8)
    for variant in ("std", "ar"):
        Ws, Hs = nt.nndsvd(Xs, 5, variant=variant, generator=gen(4), device="cpu")
        Wd, Hd = nt.nndsvd(Xd, 5, variant=variant, generator=gen(4), device="cpu")
        np.testing.assert_allclose(Ws.numpy(), Wd.numpy(), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(Hs.numpy(), Hd.numpy(), rtol=1e-6, atol=1e-9)
    W, H = nt.randinit(Xs, 5, generator=gen(5), device="cpu")
    assert W.dtype == torch.float64 and tuple(H.shape) == (5, 30)


def test_sparse_nnmf_end_to_end():
    X, _, _ = make_sparse_problem(p=40, n=30)
    for form in ("coo", "csr"):
        Xs = torch_sparse(X, form)
        for alg in ("multmse", "multdiv", "projals", "cd", "greedycd", "alspgrad"):
            ret = nt.nnmf(Xs, 4, alg=alg, init="nndsvdar", maxiter=10, device="cpu")
            dense = nt.nnmf(X, 4, alg=alg, init="nndsvdar", maxiter=10, device="cpu")
            assert np.isfinite(ret.objvalue), alg
            np.testing.assert_allclose(ret.objvalue, dense.objvalue, rtol=1e-7)
        ret = nt.nnmf(Xs, 4, alg="spa", init="spa", device="cpu")
        assert ret.converged
        np.testing.assert_allclose(
            ret.objvalue, nt.nnmf(X, 4, alg="spa", init="spa", device="cpu").objvalue,
            rtol=1e-9)
    # the container itself is taken as it is
    A = SparseCSR.from_torch_sparse(torch_sparse(X, "coo"))
    kw = dict(alg="cd", init="random", maxiter=3, device="cpu")
    assert nt.nnmf(A, 4, **kw) == nt.nnmf(torch_sparse(X, "coo"), 4, **kw)


def test_sparse_negative_validation():
    X, _, _ = make_sparse_problem()
    X[0, np.nonzero(X[0])[0][0]] *= -1
    with pytest.raises(ValueError, match="non-negative"):
        nt.nnmf(torch_sparse(X, "csr"), 3, device="cpu")


def test_from_bcoo_matches_build_tiled():
    X, _, _ = make_sparse_problem(p=300, n=260, density=0.05)
    X = X.astype(np.float32)
    r, c = np.nonzero(X)
    want = build_tiled(r, c, X[r, c], X.shape, device="cpu", coo_tail_nnz=3)
    got = from_bcoo(torch_sparse(X, "coo_dups"), coo_tail_nnz=3, device="cpu")
    for name in ("row_idx", "col_idx", "values", "row_perm", "col_rank", "stats"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for side in ("fwd", "bwd"):
        a, b = getattr(got, side), getattr(want, side)
        for f in ("coords", "vals", "coo_ptr", "coo_vals", "piece_ptr"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (side, f)
    assert got.build_opts == want.build_opts


def test_sparse_from_numpy_takes_a_bcoo_s_arrays():
    X, _, _ = make_sparse_problem()
    Xb = jsparse.BCOO.fromdense(jnp.asarray(X))
    A = convert.sparse_from_numpy(np.asarray(Xb.indices), np.asarray(Xb.data), Xb.shape,
                                  device="cpu")
    B = SparseCSR.from_torch_sparse(torch_sparse(X, "csr"))
    assert A.dtype == torch.float64
    for f in ("crow", "row", "col", "val", "src"):
        assert torch.equal(getattr(A.fwd, f), getattr(B.fwd, f))
        assert torch.equal(getattr(A.bwd, f), getattr(B.bwd, f))
