"""Tests of the PyTorch/CUDA build that need a CUDA device: the hand-written
kernels against their plain versions, and the card against the CPU on a small
solve.  They skip without a device (a CUDA kernel has no interpret mode).

This file imports neither ``jax`` nor the JAX package, so it also runs where
only PyTorch is installed::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import mu as tmu
from nmf_tpu_torch.ops.cuda import objectives as tobj
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.sparse_format import build_tiled, recut_pieces

from torch_parity import (BUILD, QUAD_BUILD, coo_of, four_class_matrix,
                          three_class_matrix)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    return "cuda"


def close(got, want, rtol=2e-5, scale=1e-5):
    """f32 sums in another order: ``rtol`` with ``atol = scale * max|want|``."""
    want = want.cpu().numpy()
    np.testing.assert_allclose(
        got.cpu().numpy(), want, rtol=rtol, atol=scale * np.abs(want).max()
    )


@pytest.mark.parametrize("order", ["degree", "natural"])
@pytest.mark.parametrize("k", [8, 9, 128, 200])
def test_kernels_match_plain_versions_on_the_card(card, order, k):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card, order=order, **BUILD)
    build.reset_launch_counts()
    for side in (Xt.fwd, Xt.bwd):
        D = torch.rand(side.cols, k, device=card)
        close(tsp.chunk_matmul(side, D), tsp.chunk_matmul_plain(side, D))
        want = tsp.dense_matmul_plain(side, D.double())
        close(tsp.dense_matmul(side, D), want)
        # every panel of two or more blocks split: the partials added in order
        cut = recut_pieces(side, dcap=1)
        assert cut.dsplit_panel.numel() > 0
        got = tsp.dense_matmul(cut, D)
        close(got, want)
        assert torch.equal(got, tsp.dense_matmul(cut, D))
        acc = torch.ones(side.rows, k, device=card)
        assert tsp.dense_matmul(side, D, acc) is acc
        close(acc, want + 1)
        acc = torch.ones(side.rows, k, device=card)
        assert tsp.coo_matmul(side, D, acc) is acc
        close(acc, tsp.coo_matmul_plain(side, D.double(), torch.ones_like(want)))
    counts = build.launch_counts()
    assert (counts["chunk_matmul"], counts["dense_matmul"], counts["coo_matmul"]) == (2, 8, 2)
    assert sum(counts.values()) == 12
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), torch.from_numpy(Xd).to(card) @ D)
    D2 = torch.rand(Xd.shape[0], k, device=card)
    close(tsp.tiled_mtm(Xt, D2), torch.from_numpy(Xd).to(card).T @ D2)
    counts = build.launch_counts()
    assert (counts["chunk_matmul"], counts["dense_matmul"], counts["coo_matmul"]) == (4, 10, 4)


@pytest.mark.parametrize("k", [1, 8, 9, 128, 200])
def test_band_kernel_matches_its_plain_version(card, k):
    """The band kernel against its plain version in float64, for every width
    it moves (4, 2 or 1 floats, by k and by the operands' alignment), the
    same bits twice, rows without band entries left as they were."""
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    for side in (Xt.fwd, Xt.bwd):
        assert side.n_coo > 0
        flat = torch.rand(side.cols * k + 1, device=card)
        for D in (flat[: side.cols * k].view(-1, k), flat[1:].view(-1, k)):
            start = torch.rand(side.rows * k + 1, device=card)
            for out in (start[: side.rows * k].view(-1, k), start[1:].view(-1, k)):
                want = tsp.coo_matmul_plain(side, D.double(), out.double())
                a = tsp.coo_matmul(side, D, out.clone())
                close(a, want)
                assert torch.equal(a, tsp.coo_matmul(side, D, out.clone()))
                empty = side.coo_ptr.diff() == 0
                assert torch.equal(a[empty], out[empty])


def test_kernels_give_the_same_bits_from_run_to_run(card):
    """The whole product over a store with dense blocks and a band, both
    orientations, also with every dense panel split: no atomics anywhere."""
    Xd = three_class_matrix(1)
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    assert Xt.fwd.n_dblocks and Xt.fwd.n_coo and Xt.bwd.n_dblocks and Xt.bwd.n_coo
    cut = dataclasses.replace(Xt, fwd=recut_pieces(Xt.fwd, dcap=1),
                              bwd=recut_pieces(Xt.bwd, dcap=1))
    for X in (Xt, cut):
        D = torch.rand(Xd.shape[1], 64, device=card)
        D2 = torch.rand(Xd.shape[0], 64, device=card)
        assert torch.equal(tsp.tiled_mm(X, D), tsp.tiled_mm(X, D))
        assert torch.equal(tsp.tiled_mtm(X, D2), tsp.tiled_mtm(X, D2))


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    side = build_tiled(r, c, v, Xd.shape, device=card, **BUILD).fwd
    # one past the chunk kernel's panel: the kernel refuses it, the whole
    # product takes it in column slabs
    D = torch.rand(side.cols, tsp.MAX_K + 1, device=card)
    with pytest.raises(ValueError, match="k must be in"):
        tsp.chunk_matmul(side, D)
    want = tsp.dense_matmul_plain(side, D, tsp.chunk_matmul_plain(side, D))
    close(tsp.tiled_matmul_t(side, D), tsp.coo_matmul(side, D, want))
    with pytest.raises(ValueError, match="lives on"):
        tsp.chunk_matmul(side, torch.zeros(side.cols, 8))
    with pytest.raises(TypeError):
        tsp.dense_matmul(side, torch.zeros(side.cols, 8, device=card, dtype=torch.float64))


def test_solve_on_the_card_agrees_with_the_cpu(card):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(2)
    W0 = rng.random((Xd.shape[0], 6), dtype=np.float32)
    H0 = rng.random((6, Xd.shape[1]), dtype=np.float32)
    kw = dict(alg="cd", init="custom", W0=W0, H0=H0, maxiter=5, tol=1e-30)
    build.reset_launch_counts()
    a = nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 6, **kw)  # default device
    counts = build.launch_counts()
    assert a.W.is_cuda and counts["chunk_matmul"] > 0 and counts["dense_matmul"] > 0
    b = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD), 6,
                device="cpu", **kw)
    # products summed in another order, fed through 5 sweeps
    close(a.W, b.W, rtol=1e-4)
    close(a.H, b.H, rtol=1e-4)
    assert a.objvalue == pytest.approx(b.objvalue, rel=1e-4)
    assert a.niters == b.niters == 5


# ---------------------------------------------------------------------------
# the sampled product, the multiplicative-update kernels, the objectives


@pytest.mark.parametrize("order", ["degree", "natural"])
@pytest.mark.parametrize("k", [1, 5, 8, 128, 256])
def test_chunk_sddmm_matches_its_plain_version_on_the_card(card, order, k):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card, order=order, **BUILD)
    W = torch.rand(Xd.shape[0], k, device=card)
    H = torch.rand(k, Xd.shape[1], device=card)
    build.reset_launch_counts()
    for side, A, B in ((Xt.fwd, W, H.T.contiguous()), (Xt.bwd, H.T.contiguous(), W)):
        got = tsp.chunk_sddmm(side, A, B)
        close(got, tsp.chunk_sddmm_plain(side, A, B))
        assert torch.equal(got, tsp.chunk_sddmm(side, A, B))  # the same bits
    got = tsp.tiled_sddmm(Xt, W, H)
    assert build.launch_counts()["chunk_sddmm"] == 5
    want = (W.double() @ H.double())[Xt.row_idx.long(), Xt.col_idx.long()]
    close(got, want.float())
    # the seam routes a store on the card through the kernel
    from nmf_tpu_torch.ops import matops

    close(matops.sddmm(W, H, Xt), want.float())
    assert build.launch_counts()["chunk_sddmm"] == 6


DENSE_SHAPES = [(300, 280, 8), (257, 1030, 5), (515, 130, 70), (200, 333, 128)]


def _dense_problem(p, n, k, card):
    g = torch.Generator(device=card).manual_seed(p + n + k)
    X = torch.rand(p, n, device=card, generator=g)
    X[torch.rand(p, n, device=card, generator=g) < 0.2] = 0.0
    return (X, torch.rand(p, k, device=card, generator=g),
            torch.rand(k, n, device=card, generator=g))


@pytest.mark.parametrize("p, n, k", DENSE_SHAPES)
def test_mu_kernels_match_their_plain_versions_on_the_card(card, p, n, k):
    X, W, H = _dense_problem(p, n, k, card)
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    delta = 3.45e-4
    build.reset_launch_counts()
    for fn, plain in ((tmu.wtq, tmu.wtq_plain), (tmu.qht, tmu.qht_plain)):
        got = fn(X, W, H, delta)
        close(got, plain(Xd, Wd, Hd, delta).float())
        assert torch.equal(got, fn(X, W, H, delta))
    G, C = W.T @ W, W.T @ X
    got = tmu.mu_factor_update(H, G, C, 0.01, delta)
    close(got, tmu.mu_factor_update_plain(Hd, G.double(), C.double(), 0.01, delta).float())
    G2, C2 = H @ H.T, X @ H.T
    got = tmu.mu_factor_update(W.T, G2, C2.T, 0.01, delta)
    assert got.T.is_contiguous()
    close(got, tmu.mu_factor_update_plain(Wd.T, G2.double(), C2.double().T, 0.01, delta).float())
    for kind, fn in (("mse", tobj.mse_objective_kernel), ("kl", tobj.kl_objective_kernel)):
        got = fn(X, W, H)
        want = tobj.dense_objective_plain(Xd, Wd, Hd, kind)
        assert got.dim() == 0 and got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        assert float(got) == float(fn(X, W, H))
    assert build.launch_counts() == dict(
        chunk_matmul=0, dense_matmul=0, quad_matmul=0, coo_matmul=0, chunk_sddmm=0,
        quad_sddmm=0, mu_factor_update=2, wtq=2, qht=2, dense_objective=4,
        projectnn=0, colsum=0, scale_cols=0)


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(card):
    X, W, H = _dense_problem(64, 80, 4, card)
    with pytest.raises(ValueError, match="X must be contiguous"):
        tmu.wtq(X.T.contiguous().T, W, H, 1e-3)
    with pytest.raises(TypeError, match="must be float32"):
        tmu.qht(X, W.half(), H.half(), 1e-3)
    with pytest.raises(ValueError, match="lives on"):
        tobj.mse_objective_kernel(X, W.cpu(), H)
    # one past the old ceiling (G in shared memory): now one slab at a time
    big = 183
    F, C = torch.rand(big, 70, device=card), torch.rand(big, 70, device=card)
    G = torch.rand(big, big, device=card)
    close(tmu.mu_factor_update(F, G, C, 0.0, 1e-3),
          tmu.mu_factor_update_plain(F.double(), G.double(), C.double(), 0.0, 1e-3).float())
    with pytest.raises(ValueError, match="row-major"):
        tmu.mu_factor_update(H, W.T @ W, (X.T @ W).T, 0.0, 1e-3)
    # float64 on the card takes the plain expression and launches nothing
    build.reset_launch_counts()
    assert tmu.wtq(X.double(), W.double(), H.double(), 1e-3).dtype == torch.float64
    assert not any(build.launch_counts().values())


@pytest.mark.parametrize("alg", ["multmse", "multdiv"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "tiled"])
def test_mu_solve_on_the_card_agrees_with_the_cpu(card, alg, sparse):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(3)
    W0 = rng.random((Xd.shape[0], 6), dtype=np.float32)
    H0 = rng.random((6, Xd.shape[1]), dtype=np.float32)
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=10, tol=1e-30)
    build.reset_launch_counts()
    if sparse:
        a = nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 6, **kw)
        b = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD), 6,
                    device="cpu", **kw)
        used = ("chunk_matmul", "dense_matmul") + (("chunk_sddmm",) if alg == "multdiv" else ())
    else:
        a = nt.nnmf(Xd, 6, **kw)
        b = nt.nnmf(Xd, 6, device="cpu", **kw)
        used = ("mu_factor_update",) if alg == "multmse" else ("wtq", "qht")
    counts = build.launch_counts()
    assert a.W.is_cuda and all(counts[name] > 0 for name in used), counts
    # sums in another order, fed through 10 sweeps
    close(a.W, b.W, rtol=1e-4)
    close(a.H, b.H, rtol=1e-4)
    assert a.objvalue == pytest.approx(b.objvalue, rel=1e-4)
    assert a.niters == b.niters == 10


def test_large_dense_objective_goes_through_the_kernel(card):
    """Above 4M entries a dense float32 X on the card reads its objective
    through the kernel, for both solver families."""
    from nmf_tpu_torch.ops import objectives

    X, W, H = _dense_problem(2100, 2000, 7, card)
    assert X.numel() > objectives._SMALL
    build.reset_launch_counts()
    mse, kl = objectives.mse_objective(X, W, H), objectives.kl_objective(X, W, H)
    assert build.launch_counts()["dense_objective"] == 2
    assert float(mse) == pytest.approx(float(0.5 * ((X - W @ H).double() ** 2).sum()), rel=1e-5)
    assert float(kl) == pytest.approx(float(objectives.gkldiv(X.double(), (W @ H).double())), rel=1e-5)


@pytest.mark.parametrize("alg", ["cd", "multmse", "multdiv"])
def test_strided_dense_x_solves_on_the_card(card, alg, monkeypatch):
    """A transposed view of X goes through the entry points to the dense
    kernels (which take a row-major X only) and gives the bits of its copy."""
    from nmf_tpu_torch.ops import objectives

    monkeypatch.setattr(objectives, "_SMALL", 10)  # the objective kernel too
    A, W0, H0 = _dense_problem(90, 130, 5, card)
    view, copy = A.T, A.T.contiguous()
    W0, H0 = H0.T.contiguous(), W0.T.contiguous()
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=5, tol=1e-30)
    build.reset_launch_counts()
    a = nt.nnmf(view, 5, **kw)
    counts = build.launch_counts()
    assert counts["dense_objective"] > 0
    if alg != "cd":
        used = ("mu_factor_update",) if alg == "multmse" else ("wtq", "qht")
        assert all(counts[name] > 0 for name in used), counts
    b = nt.nnmf(copy, 5, **kw)
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    if alg != "cd":
        c = nt.solve(nt.MultUpdate(obj=alg[4:], maxiter=5, tol=1e-30), view, W0, H0)
        assert torch.equal(a.W, c.W) and torch.equal(a.H, c.H)


# ---------------------------------------------------------------------------
# the quad-tail store, wide tail tiles, GreedyCD


def _quad_store(card, order="degree", **kw):
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    return Xd, build_tiled(r, c, v, Xd.shape, device=card, order=order,
                           **dict(QUAD_BUILD, **kw))


@pytest.mark.parametrize("order", ["degree", "natural"])
@pytest.mark.parametrize("seg", [32, 16])
@pytest.mark.parametrize("k", [1, 8, 9, 128, 200])
def test_quad_kernels_match_their_plain_versions_on_the_card(card, order, seg, k):
    Xd, Xt = _quad_store(card, order, quad_seg=seg, quad_tail_nnz=seg)
    build.reset_launch_counts()
    for side in (Xt.fwd, Xt.bwd):
        assert side.n_qchunks > 0 and side.qpanel_segs.numel() >= 4
        D = torch.rand(side.cols, k, device=card)
        got = tsp.quad_matmul(side, D)
        close(got, tsp.quad_matmul_plain(side, D))
        assert torch.equal(got, tsp.quad_matmul(side, D))  # the same bits
        acc = torch.ones(side.rows, k, device=card)
        assert tsp.quad_matmul(side, D, acc) is acc
        close(acc, tsp.quad_matmul_plain(side, D) + 1)
        A = torch.rand(side.rows, k, device=card)
        smp = tsp.quad_sddmm(side, A, D)
        close(smp, tsp.quad_sddmm_plain(side, A, D))
        assert torch.equal(smp, tsp.quad_sddmm(side, A, D))
        # padding slots give exactly 0
        assert not smp[side.qinv.long() >= side.perm.shape[0]].any()
    counts = build.launch_counts()
    assert (counts["quad_matmul"], counts["quad_sddmm"]) == (6, 4)
    assert sum(counts.values()) == 10
    X = torch.from_numpy(Xd).to(card)
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), X @ D)
    D2 = torch.rand(Xd.shape[0], k, device=card)
    close(tsp.tiled_mtm(Xt, D2), X.T @ D2)
    W, H = torch.rand(Xd.shape[0], k, device=card), torch.rand(k, Xd.shape[1], device=card)
    want = (W.double() @ H.double())[Xt.row_idx.long(), Xt.col_idx.long()]
    close(tsp.tiled_sddmm(Xt, W, H), want.float())
    counts = build.launch_counts()
    assert (counts["quad_matmul"], counts["quad_sddmm"]) == (8, 5)


def test_quad_kernel_takes_k_up_to_its_ceiling(card):
    """The quad product keeps a (128, k) panel in shared memory: k up to
    ``MAX_K`` launches, one more is refused by the wrapper and taken by the
    whole product in column slabs."""
    Xd, Xt = _quad_store(card)
    side = Xt.fwd
    D = torch.rand(side.cols, tsp.MAX_K, device=card)
    close(tsp.quad_matmul(side, D), tsp.quad_matmul_plain(side, D))
    close(tsp.chunk_matmul(side, D), tsp.chunk_matmul_plain(side, D))
    D = torch.rand(side.cols, tsp.MAX_K + 1, device=card)
    with pytest.raises(ValueError, match="k must be in"):
        tsp.quad_matmul(side, D)
    X = torch.from_numpy(Xd).to(card)
    Dm = torch.rand(Xd.shape[1], tsp.MAX_K + 1, device=card)
    close(tsp.tiled_mm(Xt, Dm), (X.double() @ Dm.double()).float())
    with pytest.raises(ValueError, match="lives on"):
        tsp.quad_matmul(side, torch.zeros(side.cols, 8))
    with pytest.raises(TypeError):
        tsp.quad_sddmm(side, torch.zeros(side.rows, 8, device=card, dtype=torch.float64),
                       torch.zeros(side.cols, 8, device=card))


@pytest.mark.parametrize("span", [2, 4, 16])
@pytest.mark.parametrize("k", [9, 128])
def test_wide_tail_tiles_on_the_card(card, span, k):
    """Kernels 1 and 4 at ``tail_span > 1``: a slot's column comes from a
    wide panel."""
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card, stripe_tiles=2, group=8,
                     dense_tile_nnz=1000, tail_span=span, coo_tail_nnz=2)
    for side in (Xt.fwd, Xt.bwd):
        assert side.span == span
        D = torch.rand(side.cols, k, device=card)
        A = torch.rand(side.rows, k, device=card)
        close(tsp.chunk_matmul(side, D), tsp.chunk_matmul_plain(side, D))
        close(tsp.chunk_sddmm(side, A, D), tsp.chunk_sddmm_plain(side, A, D))
    X = torch.from_numpy(Xd).to(card)
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), X @ D)
    W, H = torch.rand(Xd.shape[0], k, device=card), torch.rand(k, Xd.shape[1], device=card)
    want = (W.double() @ H.double())[Xt.row_idx.long(), Xt.col_idx.long()]
    close(tsp.tiled_sddmm(Xt, W, H), want.float())


@pytest.mark.parametrize("alg, used", [
    ("cd", ("chunk_matmul", "dense_matmul", "quad_matmul")),
    ("greedycd", ("chunk_matmul", "dense_matmul", "quad_matmul")),
    ("multdiv", ("chunk_matmul", "dense_matmul", "quad_matmul", "chunk_sddmm",
                 "quad_sddmm")),
])
def test_solve_on_a_quad_store_on_the_card_agrees_with_the_cpu(card, alg, used):
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(3)
    W0 = rng.random((Xd.shape[0], 6), dtype=np.float32)
    H0 = rng.random((6, Xd.shape[1]), dtype=np.float32)
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=3, tol=1e-30)
    build.reset_launch_counts()
    a = nt.nnmf(build_tiled(r, c, v, Xd.shape, **QUAD_BUILD), 6, **kw)
    counts = build.launch_counts()
    assert a.W.is_cuda and all(counts[name] > 0 for name in used), counts
    b = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **QUAD_BUILD), 6,
                device="cpu", **kw)
    # sums in another order, fed through 3 sweeps (GreedyCD picks its
    # coordinates by comparing scores, so it gets the wider limit)
    tol = 1e-3 if alg == "greedycd" else 1e-4
    close(a.W, b.W, rtol=tol, scale=tol)
    close(a.H, b.H, rtol=tol, scale=tol)
    assert a.objvalue == pytest.approx(b.objvalue, rel=1e-4)
    assert a.niters == b.niters == 3


def test_greedycd_cascade_gives_the_same_bits_on_the_card(card):
    """The compaction schedule changes how rows are batched, never a row's
    result: on the card too."""
    from nmf_tpu_torch import config

    g = torch.Generator(device=card).manual_seed(7)
    X = torch.rand(5000, 12, device=card, generator=g) @ torch.rand(12, 300, device=card, generator=g)
    W0 = torch.rand(5000, 12, device=card, generator=g)
    H0 = torch.rand(12, 300, device=card, generator=g)
    old = dict(config.greedycd_cascade)
    out = []
    try:
        for knobs in (dict(off_rows=1 << 30), dict(off_rows=1, min=16),
                      dict(off_rows=1, min=16, shrink=2)):
            config.set_greedycd_cascade(**knobs)
            out.append(nt.solve(nt.GreedyCD(maxiter=4, tol=1e-30), X, W0, H0))
    finally:
        config.greedycd_cascade.update(old)
    for r in out[1:]:
        assert torch.equal(r.W, out[0].W) and torch.equal(r.H, out[0].H)


# ---------------------------------------------------------------------------
# no k ceiling: the formerly refused k against the plain versions


@pytest.mark.parametrize("k", [183, 373, 437, 451, 512])
def test_dense_kernels_take_any_k(card, k):
    X, W, H = _dense_problem(300, 260, k, card)
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    delta = 3.45e-4
    for fn, plain in ((tmu.wtq, tmu.wtq_plain), (tmu.qht, tmu.qht_plain)):
        got = fn(X, W, H, delta)
        close(got, plain(Xd, Wd, Hd, delta).float())
        assert torch.equal(got, fn(X, W, H, delta))
    G, C = W.T @ W, W.T @ X
    got = tmu.mu_factor_update(H, G, C, 0.01, delta)
    close(got, tmu.mu_factor_update_plain(Hd, G.double(), C.double(), 0.01, delta).float())
    G2, C2 = H @ H.T, X @ H.T
    got = tmu.mu_factor_update(W.T, G2, C2.T, 0.01, delta)
    close(got, tmu.mu_factor_update_plain(Wd.T, G2.double(), C2.double().T, 0.01, delta).float())
    for kind, fn in (("mse", tobj.mse_objective_kernel), ("kl", tobj.kl_objective_kernel)):
        want = tobj.dense_objective_plain(Xd, Wd, Hd, kind)
        assert float(fn(X, W, H)) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("k", [183, 373, 437, 451, 512])
@pytest.mark.parametrize("store", ["chunk", "quad"])
def test_sparse_products_take_any_k(card, store, k):
    if store == "chunk":
        Xd = three_class_matrix()
        r, c, v = coo_of(Xd)
        Xt = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    else:
        Xd, Xt = _quad_store(card)
    X = torch.from_numpy(Xd).to(card).double()
    build.reset_launch_counts()
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), (X @ D.double()).float())
    D2 = torch.rand(Xd.shape[0], k, device=card)
    close(tsp.tiled_mtm(Xt, D2), (X.T @ D2.double()).float())
    slabs = 2 * -(-k // tsp.MAX_K)
    counts = build.launch_counts()
    assert counts["chunk_matmul"] == slabs
    assert store == "chunk" or counts["quad_matmul"] == slabs


# ---------------------------------------------------------------------------
# kernels 1 and 3 with their panels cut into pieces


@pytest.mark.parametrize("k", [9, 128, 451])
@pytest.mark.parametrize("store", ["chunk", "quad32", "quad16"])
def test_split_panels_match_the_plain_versions_on_the_card(card, store, k):
    """Kernels 1 and 3 with most panels cut into pieces (caps as small as
    each store takes): the partial panels, added in piece order by the second
    pass, give the plain version's product and the same bits twice, kernel 3
    still adds into ``out``, and the whole product takes k = 451 in column
    slabs."""
    if store == "chunk":
        Xd = three_class_matrix()
        r, c, v = coo_of(Xd)
        Xt = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    else:
        seg = int(store[-2:])
        Xd, Xt = _quad_store(card, quad_seg=seg, quad_tail_nnz=seg)
    Xt = dataclasses.replace(
        Xt, **{name: recut_pieces(getattr(Xt, name), 128, Xt.fwd.quad_seg)
               for name in ("fwd", "bwd")})
    build.reset_launch_counts()
    for side in (Xt.fwd, Xt.bwd):
        D = torch.rand(side.cols, min(k, tsp.MAX_K), device=card)
        if store == "chunk":
            assert side.n_parts > 0 and side.split_panel.numel() > 0
            got = tsp.chunk_matmul(side, D)
            close(got, tsp.chunk_matmul_plain(side, D))
            assert torch.equal(got, tsp.chunk_matmul(side, D))
        else:
            assert side.n_qparts > 0 and side.qsplit_panel.numel() > 0
            got = tsp.quad_matmul(side, D)
            close(got, tsp.quad_matmul_plain(side, D))
            assert torch.equal(got, tsp.quad_matmul(side, D))
            acc = torch.ones(side.rows, D.shape[1], device=card)
            assert tsp.quad_matmul(side, D, acc) is acc
            close(acc, tsp.quad_matmul_plain(side, D) + 1)
    # one count a call: the second pass is part of the kernel's launch
    counts = build.launch_counts()
    direct = 4 if store == "chunk" else 6
    assert counts["chunk_matmul" if store == "chunk" else "quad_matmul"] == direct
    assert sum(counts.values()) == direct
    X = torch.from_numpy(Xd).to(card).double()
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), (X @ D.double()).float())
    D2 = torch.rand(Xd.shape[0], k, device=card)
    close(tsp.tiled_mtm(Xt, D2), (X.T @ D2.double()).float())
    slabs = 2 * -(-k // tsp.MAX_K)
    counts = build.launch_counts()
    assert counts["chunk_matmul"] == (direct if store == "chunk" else 0) + slabs
    assert store == "chunk" or counts["quad_matmul"] == direct + slabs


# ---------------------------------------------------------------------------
# kernels 10-12: the elementwise kernels


@pytest.mark.parametrize("shape", [(1000, 777), (163_000, 128), (7, 3), (1, 1)])
def test_elementwise_kernels_match_their_plain_versions(card, shape):
    from nmf_tpu_torch.ops.cuda import elementwise as ew

    g = torch.Generator(device=card).manual_seed(sum(shape))
    A = torch.randn(shape, device=card, generator=g)
    build.reset_launch_counts()
    got = ew.projectnn(A)
    assert torch.equal(got, ew.projectnn_plain(A))
    assert torch.equal(got, ew.projectnn(A))
    assert torch.equal(ew.projectnn(A.T), ew.projectnn_plain(A.T))
    Apos = A.abs() + 0.1
    s = ew.colsum(Apos)
    want = ew.colsum_plain(Apos.double())
    np.testing.assert_allclose(s.cpu().numpy(), want.cpu().numpy(), rtol=1e-6)
    assert torch.equal(s, ew.colsum(Apos))
    out = ew.scale_cols(Apos, s)
    assert torch.equal(out, ew.scale_cols_plain(Apos, s))  # IEEE division
    np.testing.assert_allclose(
        out.cpu().numpy(), (Apos.double() / want).cpu().numpy(), rtol=1e-6)
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0) | dict(
        projectnn=3, colsum=2, scale_cols=1)


def test_projectnn_kernel_keeps_nan_signed_zero_and_inf(card):
    from nmf_tpu_torch.ops.cuda import elementwise as ew

    vals = torch.tensor([-0.0, 0.0, float("nan"), -float("nan"), float("inf"),
                         -float("inf"), -1e-38, 1e-45, -2.5, 3.0])
    A = vals.repeat(1001).reshape(1430, 7).to(card)  # ragged: not a multiple of 4
    for X in (A, A[1:].contiguous()):  # 16-byte aligned and not
        got = ew.projectnn(X)
        want = ew.projectnn_plain(X)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))  # every bit
        assert torch.equal(torch.isnan(got), torch.isnan(X))


def test_numeric_utils_route_to_the_kernels_on_the_card(card):
    from nmf_tpu_torch.utils import numeric

    A = torch.rand(5000, 40, device=card)
    build.reset_launch_counts()
    numeric.projectnn(A - 0.5)
    numeric.normalize1_cols(A)
    counts = build.launch_counts()
    assert (counts["projectnn"], counts["colsum"], counts["scale_cols"]) == (1, 1, 1)
    build.reset_launch_counts()
    numeric.projectnn(A.double())  # float64 takes the plain version
    assert not any(build.launch_counts().values())


def test_nnmf_with_every_default_runs_the_kernels(card):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    build.reset_launch_counts()
    res = nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 6, maxiter=5)
    counts = build.launch_counts()
    assert res.W.is_cuda and res.niters >= 1
    assert all(counts[n] > 0 for n in ("chunk_matmul", "dense_matmul", "projectnn")), counts
    build.reset_launch_counts()
    nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 6, alg="cd", init="random",
            replicates=2, maxiter=2)
    counts = build.launch_counts()
    assert counts["colsum"] == counts["scale_cols"] == 2, counts


def test_rsvd_on_the_card_agrees_with_the_cpu_in_float64(card):
    rng = np.random.default_rng(8)
    p, n, k = 3000, 2500, 20
    Xd = (rng.random((p, 12)) @ rng.random((12, n))).astype(np.float32)
    Xd[rng.random((p, n)) < 0.9] = 0.0
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, (p, n), dense_tile_nnz=192, coo_tail_nnz=3)
    U, s, V = nt.rsvd(Xt, k, generator=torch.Generator().manual_seed(3))
    Uc, sc, Vc = nt.rsvd(Xd.astype(np.float64), k, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    assert U.is_cuda and U.dtype == torch.float32
    np.testing.assert_allclose(s.cpu().numpy(), sc.numpy(), rtol=1e-4)
    # orthonormal as far as the last CholeskyQR pass's shift allows: it adds
    # l * eps * trace(G) to a Gram close to I, about l^2 eps (1.1e-4 here)
    shift = (k + 10) ** 2 * torch.finfo(torch.float32).eps
    assert float((U.T @ U - torch.eye(k, device=card)).abs().max()) <= 2 * shift
