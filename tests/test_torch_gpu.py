"""Tests of the PyTorch/CUDA build that need a CUDA device: the hand-written
kernels against their plain versions, and the card against the CPU on a small
solve.  They skip without a device (a CUDA kernel has no interpret mode).

This file imports neither ``jax`` nor the JAX package, so it also runs where
only PyTorch is installed::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import dataclasses
import math

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


def _sparse_wide(seed=3, p=200, n=50_000, density=0.0003):
    """Most slots padding: about five entries a 128 x 128 tile, so nearly
    every chunk holds a few entries at its front, and each of the two row
    panels lists some 390 chunks (more than a thread block scans at once)."""
    rng = np.random.default_rng(seed)
    nnz = int(p * n * density)
    key = np.unique(rng.integers(0, p, nnz) * n + rng.integers(0, n, nnz))
    return ((key // n).astype(np.int32), (key % n).astype(np.int32),
            (rng.random(len(key)) + 0.5).astype(np.float32), (p, n))


def _sddmm_store(card, store):
    if store == "wide_padding":
        r, c, v, shape = _sparse_wide()
        return build_tiled(r, c, v, shape, device=card, stripe_tiles=2, group=8,
                           order="natural")
    Xd = four_class_matrix() if store == "span4" else three_class_matrix()
    r, c, v = coo_of(Xd)
    opts = QUAD_CASES_SPAN4 if store == "span4" else dict(BUILD, order="degree")
    return build_tiled(r, c, v, Xd.shape, device=card, **opts)


QUAD_CASES_SPAN4 = dict(stripe_tiles=2, group=8, tail_span=4, dense_tile_nnz=1000,
                        coo_tail_nnz=2, order="natural")


@pytest.mark.parametrize("k", [1, 3, 127, 128, 129, 193, 451])
@pytest.mark.parametrize("store", ["degree", "span4", "wide_padding"])
def test_chunk_sddmm_kernel_at_its_edges(card, store, k):
    """Kernel 4 at k below and above a lane's 16 floats, k % 4 != 0, above
    the W panel it stages (192) and a sparse product's slab (450); on wide
    tail tiles and on a store that is mostly padding: within 2e-5 of float64
    at every slot, exactly 0 at padding slots, the same bits twice and the
    same bits with the pieces cut at 128 entries."""
    Xt = _sddmm_store(card, store)
    side = Xt.fwd
    g = torch.Generator(device=card).manual_seed(k)
    W = torch.rand(side.rows, k, device=card, generator=g)
    Ht = torch.rand(side.cols, k, device=card, generator=g)
    build.reset_launch_counts()
    got = tsp.chunk_sddmm(side, W, Ht)
    want = tsp.chunk_sddmm_plain(side, W.double(), Ht.double())
    assert (got.double() - want).abs().max() <= 2e-5 * want.abs().max()
    pad = side.inv >= side.perm.shape[0]
    if store == "wide_padding":
        assert pad.float().mean() > 0.9
    assert pad.any() and not got[pad].any()
    assert torch.equal(got, tsp.chunk_sddmm(side, W, Ht))
    assert torch.equal(got, tsp.chunk_sddmm(recut_pieces(side, 128), W, Ht))
    assert build.launch_counts()["chunk_sddmm"] == 3


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
        chunk_matmul=0, dense_matmul=0, quad_matmul=0, coo_matmul=0, csr_matmul=0,
        chunk_sddmm=0, quad_sddmm=0, mu_factor_update=2, wtq=2, qht=2, dense_objective=4,
        projectnn=0, colsum=0, scale_cols=0, hals_sweep=0)


@pytest.mark.parametrize("k", [1, 9, 63, 64, 65, 128, 129, 183, 373, 437, 512])
@pytest.mark.parametrize("n, shift", [(777, 0), (776, 0), (776, 1)])
def test_objective_kernel_at_the_tile_edges(card, n, shift, k):
    """Kernel 6, both kinds, at 1,001 rows (no multiple of a step) by 777
    (4-byte copies) or 776 columns, X aligned or one float off a 16-byte
    boundary, k on both sides of each slab and every k of the old ceilings:
    within 2e-5 of float64, the same bits twice."""
    p = 1001
    g = torch.Generator(device=card).manual_seed(n + shift + k)
    X = torch.rand(p * n + shift, device=card, generator=g)[shift:].view(p, n)
    X[X < 0.1] = 0.0  # exact zeros: the KL term's x = 0 branch
    W = torch.rand(p, k, device=card, generator=g)
    H = torch.rand(k, n, device=card, generator=g)
    assert tmu.check_dense_problem(X, W, H, "objective")[5] == int(n % 4 == 0 and not shift)
    build.reset_launch_counts()
    for kind, fn in (("mse", tobj.mse_objective_kernel), ("kl", tobj.kl_objective_kernel)):
        got = fn(X, W, H)
        want = float(tobj.dense_objective_plain(X.double(), W.double(), H.double(), kind))
        assert abs(float(got) - want) <= 2e-5 * abs(want)
        assert torch.equal(got, fn(X, W, H))
    assert build.launch_counts()["dense_objective"] == 4


def test_objective_kernel_at_extreme_entries(card):
    """Kernel 6 with three entries of X far from the rest (1e-30, 3e-20,
    1e19): within 2e-5 of float64, the same bits twice."""
    X, W, H = _dense_problem(300, 280, 8, card)
    X[5, 7], X[100, 200], X[299, 279] = 1e-30, 1e19, 3e-20
    for kind, fn in (("mse", tobj.mse_objective_kernel), ("kl", tobj.kl_objective_kernel)):
        got = fn(X, W, H)
        want = float(tobj.dense_objective_plain(X.double(), W.double(), H.double(), kind))
        assert abs(float(got) - want) <= 2e-5 * abs(want)
        assert torch.equal(got, fn(X, W, H))


def test_objective_kernel_where_the_quotient_leaves_the_float_range(card):
    """Kernel 6 takes the KL term as x * log(x / wh) with a branch-free
    division; where W @ H is subnormal that division cannot be formed, and
    the block walks its run again with two logf: still within 2e-5 of
    float64, the same bits twice."""
    X, W, H = _dense_problem(300, 280, 8, card)
    W[5] = 0.0
    W[5, 0] = 1e-39  # row 5 of W @ H subnormal, X's row 5 positive there
    X[5] = X[5].abs() + 0.5
    got = tobj.kl_objective_kernel(X, W, H)
    want = float(tobj.dense_objective_plain(X.double(), W.double(), H.double(), "kl"))
    assert abs(float(got) - want) <= 2e-5 * abs(want)
    assert torch.equal(got, tobj.kl_objective_kernel(X, W, H))


@pytest.mark.parametrize("case", ["wh_above_2^64", "x_below_2^-64", "wh_above_2^126"])
def test_objective_kernel_where_the_operands_leave_the_divisions_range(card, case):
    """Kernel 6's KL term where an operand of x / wh lies outside 2^-64 ..
    2^64, the range in which the divergence products use the quotient: wh
    near 1e25 (with x of 1, 1e-20, so that the quotient is subnormal, and
    0); x from 1e-20 down to subnormal 1e-45 against wh near 1; one wh of
    2e38, whose reciprocal the division flushes to 0, so that the block
    walks its run again with two logf.  Within 2e-5 of float64, the same
    bits twice."""
    X, W, H = _dense_problem(300, 280, 8, card)
    if case == "wh_above_2^64":
        W[5] *= 1e25
        X[5, :100] = 1.0
        X[5, 100:200] = 1e-20
        X[5, 200:] = 0.0
    elif case == "x_below_2^-64":
        X[7] = torch.tensor([1e-20, 1e-30, 1e-38, 1e-40, 1e-45, 0.0, 5e-20],
                            device=card).repeat(40)
    else:
        W[5] = 0.0
        W[5, 0], H[0, 7] = 1e19, 2e19
        X[5, 7] = 0.5
    got = tobj.kl_objective_kernel(X, W, H)
    want = float(tobj.dense_objective_plain(X.double(), W.double(), H.double(), "kl"))
    assert math.isfinite(float(got)) and abs(float(got) - want) <= 2e-5 * abs(want)
    assert torch.equal(got, tobj.kl_objective_kernel(X, W, H))


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


def _quad_sddmm_store(card, store):
    if store == "nearly_all_padding":
        r, c, v, shape = _sparse_wide()
        return build_tiled(r, c, v, shape, device=card, stripe_tiles=2, group=8,
                           quad_tail_nnz=32, order="natural")
    seg = 16 if store.startswith("seg16") else 32
    return _quad_store(card, "natural" if store.endswith("natural") else "degree",
                       quad_seg=seg, quad_tail_nnz=seg)[1]


@pytest.mark.parametrize("k", [1, 16, 17, 128, 129, tsp.SDDMM_STAGE_K - 1,
                               tsp.SDDMM_STAGE_K + 1, 450])
@pytest.mark.parametrize("store", ["seg32_degree", "seg16_natural", "nearly_all_padding"])
def test_quad_sddmm_kernel_at_its_edges(card, store, k):
    """Kernel 5 at k below and above a lane's 16 floats, on both sides of a
    group of 8 lanes (128 / 129), of the W panel it stages and at a sparse
    product's slab (450); seg 32 and 16 and a store that is nearly all
    padding: within 2e-5 of float64 at every slot, exactly 0 at padding
    slots, the same bits twice and the same bits with the pieces cut at 64
    entries (panels split)."""
    Xt = _quad_sddmm_store(card, store)
    side = Xt.fwd
    g = torch.Generator(device=card).manual_seed(k)
    W = torch.rand(side.rows, k, device=card, generator=g)
    Ht = torch.rand(side.cols, k, device=card, generator=g)
    build.reset_launch_counts()
    got = tsp.quad_sddmm(side, W, Ht)
    want = tsp.quad_sddmm_plain(side, W.double(), Ht.double())
    assert (got.double() - want).abs().max() <= 2e-5 * want.abs().max()
    pad = side.qinv >= side.perm.shape[0]
    if store == "nearly_all_padding":
        assert pad.float().mean() > 0.9
    assert pad.any() and not got[pad].any()
    assert torch.equal(got, tsp.quad_sddmm(side, W, Ht))
    cut = recut_pieces(side, qcap=64)
    assert cut.qsplit_panel.numel() > 0 or store != "nearly_all_padding"
    assert torch.equal(got, tsp.quad_sddmm(cut, W, Ht))
    assert build.launch_counts()["quad_sddmm"] == 3


@pytest.mark.parametrize("k", [1, 3, 8, 63, 64, 65, 129, 450])
@pytest.mark.parametrize("m", [333, 1028])
def test_mu_factor_update_kernel_at_its_edges(card, k, m):
    """Kernel 7 in both layouts (the H step's row-major F, the W step's
    transposed views) at k across a slab and its row quads, m no multiple
    of any tile width (333: 4-byte copies of a row-major F; 1028: 16-byte
    ones and a partial last tile), against float64
    within 2e-5: the same bits twice, at every tile width it has and on
    operands one float past a 16-byte boundary (4-byte copies)."""
    g = torch.Generator(device=card).manual_seed(k + m)
    F = torch.rand(k, m, device=card, generator=g)
    G = torch.rand(k, k, device=card, generator=g) / k
    C = torch.rand(k, m, device=card, generator=g) - 0.1
    delta = 3.45e-4
    build.reset_launch_counts()
    for layout in ("rows", "trans"):
        if layout == "trans":  # views of row-major (m, k) tensors
            F, C = F.T.contiguous().T, C.T.contiguous().T
        got = tmu.mu_factor_update(F, G, C, 0.01, delta)
        assert got.stride() == F.stride()
        close(got, tmu.mu_factor_update_plain(F.double(), G.double(), C.double(), 0.01,
                                              delta).float())
        assert torch.equal(got, tmu.mu_factor_update(F, G, C, 0.01, delta))
        rule = tmu.mu_tiling
        try:
            for w in tmu.MU_WIDTHS if k <= tmu.MU_SLAB else ():
                tmu.mu_tiling = lambda k_, m_, sms, w=w: rule(k_, m_, sms, w)
                assert torch.equal(got, tmu.mu_factor_update(F, G, C, 0.01, delta))
        finally:
            tmu.mu_tiling = rule
        # the same operands one float past a 16-byte boundary
        base = F.T if layout == "trans" else F
        buf = torch.empty(base.numel() + 1, device=card)
        Fs = buf[1:].view(base.shape).copy_(base)
        Fs = Fs.T if layout == "trans" else Fs
        assert Fs.data_ptr() % 16 == 4 and torch.equal(Fs, F)
        assert torch.equal(got, tmu.mu_factor_update(Fs, G, C, 0.01, delta))
    assert build.launch_counts()["mu_factor_update"] == 2 * (
        3 + (len(tmu.MU_WIDTHS) if k <= tmu.MU_SLAB else 0))


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


def _ulps_off(got, want):
    """Largest distance in float32 ulps of ``got`` from ``want`` (float64)
    rounded to float32; both of one sign."""
    a = got.contiguous().view(torch.int32).to(torch.int64)
    b = want.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return int((a - b).abs().max())


def _colsum_held(A):
    """Kernel 11 on A: one launch, every column within 1 ulp of the float64
    sum, the same bits twice and from two streams at once."""
    from nmf_tpu_torch.ops.cuda import elementwise as ew

    build.reset_launch_counts()
    got = ew.colsum(A)
    assert build.launch_counts()["colsum"] == 1
    assert got.shape == (A.shape[1],)
    assert _ulps_off(got, A.double().sum(0)) <= 1
    assert torch.equal(got, ew.colsum(A))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(ew.colsum(A))
    torch.cuda.synchronize()
    assert all(torch.equal(o, got) for o in outs)


@pytest.mark.parametrize("n", [1, 3, 4, 127, 128, 450, 512])
@pytest.mark.parametrize("m", [1, 1000, 9973, 163_001])
def test_colsum_kernel_at_its_edges(card, m, n):
    g = torch.Generator(device=card).manual_seed(m + n)
    _colsum_held(torch.rand((m, n), device=card, generator=g))


def test_colsum_kernel_on_a_misaligned_matrix(card):
    g = torch.Generator(device=card).manual_seed(5)
    base = torch.rand(9973 * 128 + 1, device=card, generator=g)
    A = base[1:].view(9973, 128)  # 4 bytes off: the one-column loads
    assert A.is_contiguous() and A.data_ptr() % 16
    _colsum_held(A)


@pytest.mark.parametrize("store", ["chunk", "quad"])
def test_store_sums_on_the_card_repeat_bit_for_bit(card, store):
    from nmf_tpu_torch.ops import matops

    Xd = three_class_matrix() if store == "chunk" else four_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device=card,
                     **(BUILD if store == "chunk" else QUAD_BUILD))
    build.reset_launch_counts()
    cs, rs = matops.colsums(Xt), matops.rowsums(Xt)
    assert build.launch_counts()["chunk_matmul"] == 2
    close(cs, torch.from_numpy(Xd.sum(0, dtype=np.float64)))
    close(rs, torch.from_numpy(Xd.sum(1, dtype=np.float64)))
    assert torch.equal(cs, matops.colsums(Xt)) and torch.equal(rs, matops.rowsums(Xt))
    assert torch.equal(cs, matops.colsums(Xt.slim()))


def test_a_caller_with_tf32_on_gets_the_ieee_solve(card):
    """The caller sets ``torch.set_float32_matmul_precision("high")``: a
    dense HALS and a default ``nnmf`` solve give the bits they give under
    ``"highest"``, and the caller's setting reads ``"high"`` afterwards; a
    bare product outside the solves does run in TF32."""
    rng = np.random.default_rng(12)
    X = torch.from_numpy((rng.random((600, 12)) @ rng.random((12, 500))).astype(
        np.float32)).to(card)
    H = torch.rand(500, 12, device=card)
    runs = {"hals": lambda: nt.nnmf(X, 12, alg="cd", init="random", maxiter=3),
            "defaults": lambda: nt.nnmf(X, 12, maxiter=3)}
    got = {}
    try:
        for setting in ("highest", "high"):
            torch.set_float32_matmul_precision(setting)
            got[setting] = {name: run() for name, run in runs.items()}
            got[setting]["bare"] = X @ H
            assert torch.get_float32_matmul_precision() == setting
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.fp32_precision = "none"
    for name in runs:
        a, b = got["highest"][name], got["high"][name]
        assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H), name
    assert not torch.equal(got["highest"]["bare"], got["high"]["bare"])


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


def test_fnnls_columns_keep_their_bits_in_any_buffer_on_the_card(card):
    """The batched solve's library routine depends on the batch's size;
    FNNLS solves in batches of ``SOLVE_BATCH``, so the cascade, a plain run
    and a run of a few of the columns give the same bits."""
    from nmf_tpu_torch.ops import fnnls

    g = torch.Generator(device=card).manual_seed(4)
    A = torch.rand((300, 32), generator=g, device=card, dtype=torch.float64)
    B = torch.rand((300, 3000), generator=g, device=card, dtype=torch.float64) - 0.3
    AtA, AtB = A.T @ A, A.T @ B
    plain = nt.nnls_gram(AtA, AtB, cascade=False)
    cas = nt.nnls_gram(AtA, AtB, cascade=True)
    few = nt.nnls_gram(AtA, AtB[:, 7:50].contiguous(), cascade=False)
    assert torch.equal(plain, cas) and torch.equal(plain[:, 7:50], few)
    want = nt.nnls_gram(AtA.cpu(), AtB.cpu(), cascade=False, device="cpu")
    np.testing.assert_allclose(plain.cpu().numpy(), want.numpy(), rtol=0, atol=1e-10)
    assert fnnls.SOLVE_BATCH > 43


def test_spa_on_the_card_picks_the_cpus_anchors_and_exact_columns(card):
    Xd = three_class_matrix(3)
    r, c, v = coo_of(Xd)
    k = 6
    W, H = nt.spa(build_tiled(r, c, v, Xd.shape, **BUILD), k)
    Wc, Hc = nt.spa(build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD), k,
                    device="cpu")
    assert W.is_cuda and torch.equal(W.cpu(), Wc)
    close(H, Hc, rtol=1e-4)


@pytest.mark.parametrize("alg", ["projals", "alspgrad"])
def test_als_solvers_on_the_card_follow_the_cpu(card, alg):
    Xd = three_class_matrix(2)
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(4)
    W0 = rng.random((Xd.shape[0], 5), dtype=np.float32)
    H0 = rng.random((5, Xd.shape[1]), dtype=np.float32)
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=2, tol=1e-30)
    build.reset_launch_counts()
    res = nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 5, **kw)
    counts = build.launch_counts()
    ref = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD), 5,
                  device="cpu", **kw)
    assert all(counts[n] > 0 for n in ("chunk_matmul", "dense_matmul")), counts
    assert (counts["projectnn"] > 0) == (alg == "projals"), counts
    close(res.W, ref.W, rtol=1e-3, scale=1e-4)
    close(res.H, ref.H, rtol=1e-3, scale=1e-4)


@pytest.mark.parametrize("k", [1, 9, 128, 460])
def test_general_sparse_products_run_the_band_kernel(card, k):
    """A torch CSR X on the card: ``mm`` / ``mtm`` through the general-CSR
    kernel over the rows' pieces (one launch a slab; no launch of the band
    kernel), against the plain version, the same bits twice."""
    from nmf_tpu_torch.ops import matops

    Xd = three_class_matrix(5)
    X = matops.as_operand(torch.from_numpy(Xd).to(card).to_sparse_csr())
    Xc = matops.as_operand(torch.from_numpy(Xd).to_sparse_csr())
    D = torch.rand(Xd.shape[1], k, device=card)
    D2 = torch.rand(k, Xd.shape[0], device=card)
    build.reset_launch_counts()
    got, got_t = matops.mm(X, D), matops.mtm(D2, X)
    slabs = -(-k // tsp.MAX_K)
    assert build.launch_counts()["csr_matmul"] == 2 * slabs
    assert sum(build.launch_counts().values()) == 2 * slabs
    close(got, matops.mm(Xc, D.cpu()))
    close(got_t, matops.mtm(D2.cpu(), Xc))
    assert torch.equal(got, matops.mm(X, D)) and torch.equal(got_t, matops.mtm(D2, X))
    W, H = torch.rand(Xd.shape[0], 4, device=card), torch.rand(4, Xd.shape[1], device=card)
    close(matops.sddmm(W, H, X), matops.sddmm(W.cpu(), H.cpu(), Xc))
    close(matops.colsums(X), torch.from_numpy(Xd.sum(0)))


@pytest.mark.parametrize("k", [4, 9, 128, 200])
def test_general_csr_kernel_with_split_rows(card, k):
    """Rows cut into pieces of at most 8 entries, so most rows split: the
    general-CSR kernel against its plain version (which follows its order)
    in float64, the same bits twice, in column slabs and with evict-first
    loads too; rows of one piece equal the band kernel over ``crow`` bit for
    bit."""
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.sparse_format import csr_piece_index

    Xd = three_class_matrix(5)
    A = matops.as_operand(torch.from_numpy(Xd).to(card).to_sparse_csr())
    for side in (A.fwd, A.bwd):
        cut = dataclasses.replace(side, **csr_piece_index(side.crow, 8))
        assert cut.n_parts > 0
        D = torch.rand(side.cols, k, device=card)
        build.reset_launch_counts()
        got = tsp.csr_matmul(cut, D)
        assert build.launch_counts()["csr_matmul"] == 1
        close(got, tsp.csr_matmul_plain(cut, D.double()))
        assert torch.equal(got, tsp.csr_matmul(cut, D))
        for slab, stream in ((k, 1), (32, 0), (64, 1)):
            assert torch.equal(got, tsp.csr_launch(cut, D, slab, stream))
        band = torch.zeros(side.rows, k, device=card)
        build.launch("coo_matmul", side.crow, side.col, side.val, D, band, side.rows, k)
        short = side.crow.diff() <= 8
        assert torch.equal(got[short], band[short])
        assert torch.equal(tsp.csr_matmul(side, D), band)


def test_float64_sparse_x_on_the_card_raises(card):
    from nmf_tpu_torch.ops import matops

    X = matops.as_operand(torch.from_numpy(three_class_matrix(5)).double().to(card)
                          .to_sparse_coo())
    with pytest.raises(TypeError, match="float32"):
        matops.mm(X, torch.rand(X.shape[1], 3, device=card, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        nt.nnmf(X, 3, alg="cd", init="random", maxiter=1)


def test_checkpointed_solve_on_the_card_keeps_the_bits(card, tmp_path):
    Xd = three_class_matrix(2)
    r, c, v = coo_of(Xd)
    X = build_tiled(r, c, v, Xd.shape, **BUILD)
    rng = np.random.default_rng(4)
    W = torch.from_numpy(rng.random((Xd.shape[0], 5), dtype=np.float32)).to(card)
    H = torch.from_numpy(rng.random((5, Xd.shape[1]), dtype=np.float32)).to(card)
    alg = nt.CoordinateDescent(maxiter=9, tol=1e-30, shuffle=True,
                               generator=torch.Generator().manual_seed(3))
    plain = nt.solve(alg, X, W, H)
    ck = nt.solve_checkpointed(alg, X, W, H, checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert ck == plain and torch.equal(ck.W, plain.W)


def test_sharded_products_on_one_card_run_the_kernels(card):
    """A 2 x 2 mesh over one card: the blocks run the store's kernels (all
    four classes), the products stay within float32 rounding of the plain
    versions on a CPU mesh, and a (1, 1) mesh gives the store's bits."""
    from nmf_tpu_torch.ops import matops

    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    on = {dev: nt.shard_tiled(r, c, v, Xd.shape, nt.make_mesh((2, 2), devices=[dev] * 4),
                              **QUAD_BUILD) for dev in (card, "cpu")}
    D = torch.rand(Xd.shape[1], 9)
    W, H = torch.rand(Xd.shape[0], 9), torch.rand(9, Xd.shape[1])
    build.reset_launch_counts()
    close(matops.mm(on[card], D.to(card)), matops.mm(on["cpu"], D))
    close(matops.mtm(W.T.to(card), on[card]), matops.mtm(W.T, on["cpu"]))
    close(matops.sddmm(W.to(card), H.to(card), on[card]), matops.sddmm(W, H, on["cpu"]))
    counts = build.launch_counts()
    assert all(counts[name] for name in ("chunk_matmul", "dense_matmul", "quad_matmul",
                                         "coo_matmul", "chunk_sddmm", "quad_sddmm")), counts
    one = nt.shard_tiled(r, c, v, Xd.shape, nt.make_mesh((1, 1), devices=[card]),
                         **QUAD_BUILD)
    store = build_tiled(r, c, v, Xd.shape, device=card, **QUAD_BUILD)
    assert torch.equal(matops.mm(one, D.to(card)), matops.mm(store, D.to(card)))


def test_sharded_solve_on_one_card_follows_the_cpu(card):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    rng = np.random.default_rng(3)
    W0 = rng.random((Xd.shape[0], 4), dtype=np.float32)
    H0 = rng.random((4, Xd.shape[1]), dtype=np.float32)
    kw = dict(alg="multdiv", init="custom", W0=W0, H0=H0, maxiter=5)
    res = {}
    for dev in (card, "cpu"):
        mesh = nt.make_mesh((2, 2), devices=[dev] * 4)
        X = nt.shard_tiled(r, c, v, Xd.shape, mesh, **BUILD)
        res[dev] = nt.nnmf(X, 4, mesh=mesh, device=mesh.lead, **kw)
    assert res[card].niters == res["cpu"].niters
    close(res[card].W, res["cpu"].W, rtol=2e-4, scale=1e-4)
    assert math.isclose(res[card].objvalue, res["cpu"].objvalue, rel_tol=1e-5)


def test_sharded_mesh_over_several_cards_gives_the_one_card_bits(card):
    """The same 2 x 2 mesh shape over distinct cards (blocks moved between
    cards, partials added on the lead card in the same order) gives the bits
    of the mesh over one card: products, sampled product and five HALS
    iterations."""
    from nmf_tpu_torch.ops import matops

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA devices")
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    meshes = [nt.make_mesh((2, 2), devices=devs) for devs in (
        ["cuda:0"] * 4, [f"cuda:{i % count}" for i in range(4)])]
    X = [nt.shard_tiled(r, c, v, Xd.shape, m, **QUAD_BUILD) for m in meshes]
    assert {b.device for row in X[1].blocks for b in row} == {
        torch.device("cuda", i) for i in range(min(count, 4))}
    D = torch.rand(Xd.shape[1], 9, device="cuda:0")
    W = torch.rand(Xd.shape[0], 9, device="cuda:0")
    H = torch.rand(9, Xd.shape[1], device="cuda:0")
    assert torch.equal(matops.mm(X[0], D), matops.mm(X[1], D))
    assert torch.equal(matops.mtm(W.T, X[0]), matops.mtm(W.T, X[1]))
    assert torch.equal(matops.sddmm(W, H, X[0]), matops.sddmm(W, H, X[1]))
    rng = np.random.default_rng(4)
    kw = dict(alg="cd", init="custom", W0=rng.random((Xd.shape[0], 4), dtype=np.float32),
              H0=rng.random((4, Xd.shape[1]), dtype=np.float32), maxiter=5)
    a, b = (nt.nnmf(x, 4, mesh=m, **kw) for x, m in zip(X, meshes))
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)


@pytest.mark.parametrize("alg", ["cd", "greedycd", "multdiv"])
def test_batched_restarts_on_the_card_follow_the_sequential_ones(card, alg):
    """Three restarts as one batch on the store against one after the
    other: the same iteration counts; the lanes stepped by the solver's own
    update (MU) give the sequential bits, the batched lanes stay within
    float32 rounding carried through the iterations.  Kernels 1, 2 and the
    band run at width 3 k."""
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    X = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    widths = []
    tiled_mm = tsp.tiled_mm
    kw = dict(alg=alg, init="random", replicates=4, maxiter=8, seed=3)
    seq = nt.nnmf(X, 5, **kw)
    try:
        tsp.tiled_mm = lambda X, D: (widths.append(D.shape[1]), tiled_mm(X, D))[1]
        build.reset_launch_counts()
        par = nt.nnmf(X, 5, parallel_replicates=True, **kw)
    finally:
        tsp.tiled_mm = tiled_mm
    assert par.niters == seq.niters and par.converged == seq.converged
    if alg == "multdiv":
        assert torch.equal(par.W, seq.W) and par.objvalue == seq.objvalue
    else:
        assert 15 in widths
        counts = build.launch_counts()
        assert all(counts[n] for n in ("chunk_matmul", "dense_matmul", "coo_matmul"))
        close(par.W, seq.W, rtol=2e-4, scale=1e-4)
        assert math.isclose(par.objvalue, seq.objvalue, rel_tol=1e-4)


def test_dense_mesh_on_one_card_follows_the_whole_x(card):
    """A dense X on a 2 x 2 mesh over one card runs kernels 6, 8 and 9 on
    its blocks and stays within float32 rounding of the whole X; a (1, 1)
    mesh gives the whole X's bits."""
    from nmf_tpu_torch.ops import matops
    from nmf_tpu_torch.ops.objectives import kl_objective, mse_objective

    rng = np.random.default_rng(5)
    # blocks of 2100 x 2050: above the 4M entries below which the objective
    # forms W @ H whole instead of launching kernel 6
    p, n = 4200, 4100
    X = torch.from_numpy(rng.random((p, n), dtype=np.float32)).to(card)
    W = torch.from_numpy(rng.random((p, 6), dtype=np.float32)).to(card)
    H = torch.from_numpy(rng.random((6, n), dtype=np.float32)).to(card)
    two = nt.shard_dense(X, nt.make_mesh((2, 2), devices=[card] * 4))
    one = nt.shard_dense(X, nt.make_mesh((1, 1), devices=[card]))
    for fn in (lambda A: matops.wtq(A, W, H, 1e-8), lambda A: matops.qht(A, W, H, 1e-8),
               lambda A: mse_objective(A, W, H), lambda A: kl_objective(A, W, H),
               lambda A: matops.mm(A, H.T), lambda A: matops.mtm(W.T, A)):
        want = fn(X)
        build.reset_launch_counts()
        got = fn(two)
        blocks = build.launch_counts()
        close(got, want)
        assert torch.equal(got, fn(two))
        assert torch.equal(fn(one), want)
        assert sum(blocks.values()) in (0, 4), blocks  # a kernel a block or none
    build.reset_launch_counts()
    for fn in (matops.wtq, matops.qht):
        fn(two, W, H, 1e-8)
    mse_objective(two, W, H)
    counts = build.launch_counts()
    assert (counts["wtq"], counts["qht"], counts["dense_objective"]) == (4, 4, 4), counts
    kw = dict(alg="multdiv", init="custom", W0=W.cpu().numpy(), H0=H.cpu().numpy(),
              maxiter=5)
    a = nt.nnmf(X, 6, mesh=two.mesh, **kw)
    b = nt.nnmf(X, 6, **kw)
    assert a.niters == b.niters
    close(a.W, b.W, rtol=2e-4, scale=1e-4)
    assert nt.nnmf(X, 6, mesh=one.mesh, **kw) == b


# ---------------------------------------------------------------------------
# the Fast-HALS sweep (hals_sweep)

# The kernel against the plain loops in float64: each g sums k terms of
# about |W| G[c, c] in float32 (the kernel in a fixed order with the slab's
# corrections, the plain version through the library's matrix-vector
# product), so a step is off by a few k eps of max|W| and the later
# columns carry it on; 1e-4 of max|W| leaves room at k = 520
HALS_TOL = 1e-4


def _hals_problem(card, m, rows, k, layout, l1, l2, zero_lane=None):
    """Lanes of one half-step as the solver hands them to the sweep: W
    ``(m, rows, k)`` row-major ("rows", the W half) or each lane a
    transposed view of a row-major ``(k, rows)`` matrix ("cols", the H
    half's ``H.T``); G = H H' + l2 I; C = X H' - l1 as the lanes' view of
    one ``(rows, m k)`` product.  In lane ``zero_lane`` component ``k // 2``
    has a zero row of H: a zero Hessian entry where ``l2`` is 0."""
    g = torch.Generator(device=card).manual_seed(rows + 7 * k + m)
    n = 2 * k + 40
    X = torch.rand(rows, n, device=card, generator=g)
    H = torch.rand(m, k, n, device=card, generator=g)
    if zero_lane is not None:
        H[zero_lane, k // 2] = 0.0
    W = torch.rand(m, rows, k, device=card, generator=g)
    if layout == "cols":
        W = W.transpose(1, 2).contiguous().transpose(1, 2)
    eye = torch.eye(k, device=card)
    G = torch.stack([h @ h.T + l2 * eye for h in H])
    C = (X @ H.permute(2, 0, 1).reshape(n, m * k) - l1).view(rows, m, k).transpose(0, 1)
    return W, G, C


def _check_hals_sweep(card, m, rows, k, layout, l1, l2, perm, zero_lane=None):
    from nmf_tpu_torch.ops.cuda import hals

    W, G, C = _hals_problem(card, m, rows, k, layout, l1, l2, zero_lane)
    want = hals.hals_sweep_plain(W.double(), G.double(), C.double(), perm)
    build.reset_launch_counts()
    got = hals.hals_sweep(W.clone(), G, C, perm)
    assert build.launch_counts()["hals_sweep"] == 1
    assert got.stride() == W.stride()
    close(got, want, rtol=HALS_TOL, scale=HALS_TOL)
    # the same bits on every run
    assert torch.equal(got, hals.hals_sweep(W.clone(), G, C, perm))
    if zero_lane is not None:
        assert torch.equal(got[zero_lane, :, k // 2], W[zero_lane, :, k // 2])
        assert not torch.equal(got[zero_lane], W[zero_lane])
    # each lane alone gives its bits in the batch
    if m > 1:
        for lane in range(m):
            one = hals.hals_sweep(W[lane:lane + 1].clone(), G[lane:lane + 1],
                                  C[lane:lane + 1], perm)
            assert torch.equal(one[0], got[lane]), lane


@pytest.mark.parametrize("order", ["natural", "shuffled"])
@pytest.mark.parametrize("l1, l2", [(0.0, 0.0), (0.05, 0.1)])
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("k", [1, 7, 64, 128, 200])
def test_hals_sweep_matches_its_plain_version(card, k, m, layout, l1, l2, order):
    """The kernel against the plain loops in float64 at 300 rows (not a
    multiple of the kernel's 128-row tile), both layouts of W and the lanes'
    strided C; a lane with a zero Hessian entry keeps that column's bits; the
    same bits twice; each of 4 lanes the bits of its own sweep."""
    perm = (range(k) if order == "natural"
            else torch.randperm(k, generator=torch.Generator().manual_seed(k)).tolist())
    _check_hals_sweep(card, m, 300, k, layout, l1, l2, perm,
                      zero_lane=m - 1 if l2 == 0 and k > 1 else None)


@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_hals_sweep_beyond_the_tile_on_chip(card, layout):
    """At k = 520 the tile of W does not fit shared memory (128 rows of
    548 floats are 280 KB, a block may take 227 KB; at k = 200 it fits):
    each thread steps its row in device memory, in the same order."""
    perm = torch.randperm(520, generator=torch.Generator().manual_seed(1)).tolist()
    _check_hals_sweep(card, 2, 300, 520, layout, 0.05, 0.0, perm, zero_lane=1)


def test_hals_sweep_refuses_what_the_kernel_does_not_take(card):
    from nmf_tpu_torch.ops.cuda import hals

    W, G, C = _hals_problem(card, 2, 50, 8, "rows", 0.0, 0.0)
    build.reset_launch_counts()
    with pytest.raises(TypeError):
        hals.hals_sweep(W.half(), G.half(), C.half(), range(8))
    with pytest.raises(TypeError, match="dtypes differ"):
        hals.hals_sweep(W, G.double(), C, range(8))
    with pytest.raises(ValueError, match="devices differ"):
        hals.hals_sweep(W, G.cpu(), C, range(8))
    with pytest.raises(ValueError, match="inconsistent"):
        hals.hals_sweep(W, G[:1], C, range(8))
    with pytest.raises(ValueError, match="inconsistent"):
        hals.hals_sweep(W, G, C[:, :49], range(8))
    with pytest.raises(ValueError, match=r"\(m, rows, k\)"):
        hals.hals_sweep(W[0], G[0], C[0], range(8))
    with pytest.raises(ValueError, match="entries"):
        hals.hals_sweep(W, G, C, range(7))
    with pytest.raises(ValueError, match="permutation"):
        hals.hals_sweep(W, G, C, [0] * 8)
    # the kernel's own refusal: more lanes than a launch takes
    many = torch.zeros(65_536, 1, 1, device=card)
    with pytest.raises(RuntimeError, match="hals_sweep failed to launch"):
        hals.hals_sweep(many, torch.ones_like(many), many.clone(), range(1))
    with pytest.raises(ValueError, match="distinct places"):
        hals.hals_sweep(W[:1].expand(2, 50, 8), G, C, range(8))
    # nothing was launched, and W is as it was
    before = W.clone()
    with pytest.raises(ValueError):
        hals.hals_sweep(W, G, C, [1] * 8)
    assert build.launch_counts()["hals_sweep"] == 0 and torch.equal(W, before)


def test_hals_solves_launch_one_sweep_a_half_step(card):
    """A HALS solve with batched restarts sweeps each half-step in one
    launch (the first solve's, then the lanes' together) and reads no
    Hessian back to the host; on a store and on a dense X the batched
    restarts give the bits of the restarts run one after the other."""
    from nmf_tpu_torch.utils import spans

    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    X = build_tiled(r, c, v, Xd.shape, device=card, **BUILD)
    kw = dict(alg="cd", init="random", replicates=4, maxiter=6, tol=1e-30, seed=3)
    build.reset_launch_counts()
    with spans.recording() as rec:
        par = nt.nnmf(X, 5, parallel_replicates=True, **kw)
    assert build.launch_counts()["hals_sweep"] == 2 * 6 + 2 * 6
    halves = [s for s in rec.spans if s.name in ("half.W", "half.H")]
    assert len(halves) == 24
    assert sum(s.counts["host_reads"] for s in halves) == 0
    assert all(s.counts["launches"] >= 1 for s in halves)
    for A, batched in ((X, par), (torch.from_numpy(Xd).to(card), None)):
        if batched is None:
            batched = nt.nnmf(A, 5, parallel_replicates=True, **kw)
        seq = nt.nnmf(A, 5, **kw)
        assert torch.equal(batched.W, seq.W) and torch.equal(batched.H, seq.H)
        assert batched.objvalue == seq.objvalue
