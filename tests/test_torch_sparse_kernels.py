"""Sparse-dense products of the PyTorch build on the CPU, where each kernel's
wrapper runs the kernel's plain version: against the JAX package's Pallas
products (interpret mode) and against the dense numpy product.

Tolerance: ``rtol=2e-5`` with ``atol=1e-5 * max|want|`` — every side sums
the same float32 terms, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu
from nmf_tpu.ops.pallas import sparse as jsp
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.sparse_format import (DENSE_GROUP, QUAD_GROUP, TILE, build_tiled,
                                             recut_pieces)

from torch_parity import (BUILD, DENSE_NNZ, QUAD_BUILD, QUAD_CASES, coo_of,
                          four_class_matrix, three_class_matrix)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=2e-5, atol=1e-5 * np.abs(want).max()
    )


def empty_middle_stripes(seed=3):
    """All nonzeros in the first and last row panels (the middle stripes are
    empty) with power-law column skew."""
    rng = np.random.default_rng(seed)
    p, n, nnz = 1200, 700, 4000
    rows = np.where(rng.random(nnz) < 0.5, rng.integers(0, 90, nnz),
                    rng.integers(p - 40, p, nnz))
    cols = np.minimum((rng.pareto(1.1, nnz) * 3).astype(np.int64), n - 1)
    Xd = np.zeros((p, n), np.float32)
    np.add.at(Xd, (rows, cols), rng.random(nnz).astype(np.float32))
    return Xd


CASES = {
    # name: (matrix, build options)
    "all_classes_degree": (three_class_matrix, dict(BUILD, order="degree")),
    "all_classes_natural": (three_class_matrix, dict(BUILD, order="natural")),
    "chunks_only": (three_class_matrix, dict(stripe_tiles=2, group=8)),
    "dense_only": (three_class_matrix, dict(stripe_tiles=2, group=8, dense_tile_nnz=1)),
    "band_and_dense": (three_class_matrix,
                       dict(stripe_tiles=2, group=8, dense_tile_nnz=DENSE_NNZ,
                            coo_tail_nnz=DENSE_NNZ - 1)),
    "empty_middle_stripes": (empty_middle_stripes,
                             dict(stripe_tiles=2, group=8, dense_tile_nnz=200,
                                  coo_tail_nnz=2)),
}


def _case(name):
    make, opts = CASES[name]
    Xd = make()
    r, c, v = coo_of(Xd)
    return Xd, (r, c, v), opts


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("k", [8, 9])
def test_mm_mtm_match_jax_and_dense(name, k):
    Xd, (r, c, v), opts = _case(name)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **opts)
    rng = np.random.default_rng(7)
    D = rng.random((Xd.shape[1], k)).astype(np.float32)
    D2 = rng.random((Xd.shape[0], k)).astype(np.float32)

    got = tsp.tiled_mm(Xt, torch.from_numpy(D))
    assert got.dtype == torch.float32 and tuple(got.shape) == (Xd.shape[0], k)
    close(got, Xd @ D)
    close(got, jsp.tiled_mm(Xj, jnp.asarray(D), precision="highest"))
    got2 = tsp.tiled_mtm(Xt, torch.from_numpy(D2))
    close(got2, Xd.T @ D2)
    close(got2, jsp.tiled_mtm(Xj, jnp.asarray(D2), precision="highest"))


def test_store_classes_of_the_cases():
    """The cases exercise what their names say."""
    def classes(name):
        Xd, (r, c, v), opts = _case(name)
        s = build_tiled(r, c, v, Xd.shape, device="cpu", **opts).fwd
        return (s.panel_chunks.numel() > 0, s.n_dblocks > 0, s.n_coo > 0)

    assert classes("all_classes_degree") == (True, True, True)
    assert classes("chunks_only") == (True, False, False)
    assert classes("dense_only") == (False, True, False)
    assert classes("band_and_dense") == (False, True, True)
    assert classes("empty_middle_stripes")[0]


def test_matops_seam_on_tiled_and_dense():
    Xd, (r, c, v), opts = _case("all_classes_degree")
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    rng = np.random.default_rng(8)
    D = rng.random((Xd.shape[1], 8)).astype(np.float32)
    Wt = rng.random((8, Xd.shape[0])).astype(np.float32)
    assert matops.is_tiled(Xt) and matops.is_sparse(Xt)
    assert not matops.is_sparse(torch.from_numpy(Xd))
    close(matops.mm(Xt, torch.from_numpy(D)), Xd @ D)
    close(matops.mtm(torch.from_numpy(Wt), Xt), Wt @ Xd)
    close(matops.mm(matops.transpose(Xt), torch.from_numpy(Wt.T.copy())), Xd.T @ Wt.T)
    # a float64 operand comes back float64 (the product itself is float32)
    assert matops.mm(Xt, torch.from_numpy(D).double()).dtype == torch.float64
    Xdt = torch.from_numpy(Xd)
    close(matops.mm(Xdt, torch.from_numpy(D)), Xd @ D)
    close(matops.mtm(torch.from_numpy(Wt), Xdt), Wt @ Xd)
    assert torch.equal(matops.transpose(Xdt), Xdt.T)


def test_matops_reductions_and_access():
    Xd, (r, c, v), opts = _case("all_classes_degree")
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    Xdt = torch.from_numpy(Xd)
    for X in (Xt, Xdt):
        np.testing.assert_allclose(float(matops.sq_norm(X)), (Xd.astype(np.float64) ** 2).sum(), rtol=1e-5)
        np.testing.assert_allclose(float(matops.total_sum(X)), Xd.sum(dtype=np.float64), rtol=1e-5)
        np.testing.assert_allclose(float(matops.mean(X)), Xd.mean(dtype=np.float64), rtol=1e-5)
        assert bool(matops.all_nonneg(X))
        close(matops.colsums(X), Xd.sum(0))
        close(matops.rowsums(X), Xd.sum(1))
    np.testing.assert_array_equal(matops.nnz_values(Xt).numpy(), v)
    np.testing.assert_array_equal(matops.col_indices(Xt).numpy(), c)
    rng = np.random.default_rng(9)
    W = rng.random((Xd.shape[0], 5)).astype(np.float32)
    H = rng.random((5, Xd.shape[1])).astype(np.float32)
    close(matops.sddmm(torch.from_numpy(W), torch.from_numpy(H), Xt), (W @ H)[r, c])
    Y = matops.scale_values(Xt, torch.from_numpy(2 * v))
    close(matops.mm(Y, torch.from_numpy(H.T.copy())), 2 * Xd @ H.T)
    neg = build_tiled(r, c, -v, Xd.shape, device="cpu", **opts)
    assert not bool(matops.all_nonneg(neg))
    S = Xt.slim()
    close(matops.mm(S, torch.from_numpy(H.T.copy())), Xd @ H.T)
    assert float(matops.sq_norm(S)) == float(matops.sq_norm(Xt))
    for fn in (matops.nnz_values, matops.col_indices):
        with pytest.raises(ValueError, match="slim"):
            fn(S)
    # the sums are the store's products with a ones column: no CSR arrays
    for fn in (matops.colsums, matops.rowsums):
        assert torch.equal(fn(S), fn(Xt))
    with pytest.raises(ValueError, match="slim"):
        matops.sddmm(torch.from_numpy(W), torch.from_numpy(H), S)


# ---------------------------------------------------------------------------
# each plain version alone, against a loop over its store arrays


def _numpy_chunk_loop(side, D):
    pps = side.panels_per_stripe
    out = np.zeros((side.n_stripes * pps * TILE, D.shape[1]), np.float64)
    coords, vals = side.coords.numpy(), side.vals.numpy()
    for ch in range(coords.shape[0]):
        w = ch // side.group
        r0 = (int(side.win_stripe[w]) * pps + int(side.chunk_rp[ch])) * TILE
        c0 = int(side.win_panel[w]) * TILE
        for s in np.flatnonzero(vals[ch]):
            co = coords[ch, s]
            out[r0 + (co & 127)] += vals[ch, s] * D[c0 + (co >> 7)]
    return out[: side.rows]


def _numpy_dense_loop(side, D):
    pps = side.panels_per_stripe
    out = np.zeros((side.n_stripes * pps * TILE, D.shape[1]), np.float64)
    Dp = np.zeros((side.n_colpanels * TILE, D.shape[1]))
    Dp[: side.cols] = D
    for b in range(side.n_dblocks):
        w = b // DENSE_GROUP
        r0 = (int(side.dblk_stripe[w]) * pps + int(side.dblk_rp[b])) * TILE
        c0 = int(side.dblk_panel[w]) * TILE
        out[r0 : r0 + TILE] += side.dvals[b].numpy().T.astype(np.float64) @ Dp[c0 : c0 + TILE]
    return out[: side.rows]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_plain_versions_against_store_loops(which):
    Xd, (r, c, v), opts = _case("all_classes_natural")
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    side = getattr(Xt, which)
    M = Xd if which == "fwd" else Xd.T
    D = np.random.default_rng(2).random((side.cols, 9)).astype(np.float32)
    Dt = torch.from_numpy(D)
    chunk = tsp.chunk_matmul_plain(side, Dt)
    dense = tsp.dense_matmul_plain(side, Dt)
    close(chunk, _numpy_chunk_loop(side, D))
    close(dense, _numpy_dense_loop(side, D))
    band = tsp.coo_matmul(side, Dt, torch.zeros(side.rows, 9))
    want_band = np.zeros((side.rows, 9))
    np.add.at(want_band, side.coo_rows.numpy(),
              side.coo_vals.numpy()[:, None] * D[side.coo_cols.numpy()])
    close(band, want_band)
    # the three classes partition the matrix
    close(chunk + dense + band, M @ D)
    # the wrappers take the plain versions on the CPU and count no launch
    before = build.launch_counts()
    assert torch.equal(tsp.chunk_matmul(side, Dt), chunk)
    assert torch.equal(tsp.dense_matmul(side, Dt), dense)
    acc = torch.ones(side.rows, 9)
    assert tsp.dense_matmul(side, Dt, acc) is acc
    close(acc, dense.numpy() + 1)
    assert build.launch_counts() == before
    assert before["chunk_matmul"] == before["dense_matmul"] == 0


def test_products_stream_in_pieces(monkeypatch):
    """The plain versions and the COO band give the same sums when the store
    is walked in many small pieces."""
    Xd, (r, c, v), opts = _case("all_classes_degree")
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    D = torch.from_numpy(np.random.default_rng(5).random((Xd.shape[1], 8)).astype(np.float32))
    whole = tsp.tiled_mm(Xt, D)
    monkeypatch.setattr(tsp, "_PIECE", 4)  # one chunk / block, 4 band entries
    assert Xt.fwd.n_coo > 4 and Xt.fwd.coords.shape[0] > 2
    close(tsp.tiled_mm(Xt, D), whole)


def _jax_dense_product(sj, D):
    """The JAX package's dense-tile product alone (its Pallas kernel in
    interpret mode, as its own tests run it on the CPU), ``(rows, k)``."""
    k = D.shape[1]
    K = -(-k // 8) * 8
    stripe_width = sj.panels_per_stripe * TILE
    Dt = jnp.pad(jnp.asarray(D, jnp.float32).T,
                 ((0, K - k), (0, sj.n_colpanels * TILE * sj.span - D.shape[0])))
    out = jsp._tiled_dense_impl(
        sj.dblk_rp, sj.dblk_panel, sj.dblk_stripe, jnp.asarray(sj.dvals, jnp.float32),
        Dt, (sj.n_dblocks, stripe_width, sj.n_stripes * stripe_width),
        pltpu.InterpretParams())
    return np.asarray(out[:k, : sj.rows].T)


@pytest.mark.parametrize("name", ["all_classes_degree", "all_classes_natural", "band_and_dense"])
def test_dense_and_band_plain_versions_match_jax_and_numpy(name):
    """The dense product summed piece by piece, and the band summed row by
    row in band order and then added once, against the JAX package's dense
    kernel and its ``segment_sum`` band, class by class, and against loops
    over the store arrays."""
    Xd, (r, c, v), opts = _case(name)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **opts)
    rng = np.random.default_rng(11)
    for st, sj in ((Xt.fwd, Xj.fwd), (Xt.bwd, Xj.bwd)):
        assert st.n_dblocks > 0 and st.n_coo > 0
        D = rng.random((st.cols, 9)).astype(np.float32)
        Dt = torch.from_numpy(D)
        dense = tsp.dense_matmul_plain(st, Dt)
        close(dense, _jax_dense_product(sj, D))
        close(dense, _numpy_dense_loop(st, D))
        start = rng.random((st.rows, 9)).astype(np.float32)
        band = tsp.coo_matmul_plain(st, Dt, torch.from_numpy(start.copy()))
        close(band - torch.from_numpy(start), np.asarray(jsp._coo_matmul(sj, jnp.asarray(D))))
        want = start.astype(np.float64)
        np.add.at(want, st.coo_rows.numpy(), st.coo_vals.numpy()[:, None] * D[st.coo_cols.numpy()])
        close(band, want)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_plain_dense_product_at_a_forced_split_matches_the_unsplit_one(which):
    Xd, (r, c, v), opts = _case("all_classes_natural")
    side = getattr(build_tiled(r, c, v, Xd.shape, device="cpu", **opts), which)
    cut = recut_pieces(side, dcap=1)
    assert cut.n_dparts > side.n_dparts and cut.dsplit_panel.numel() > 0
    D = torch.from_numpy(np.random.default_rng(12).random((side.cols, 9)).astype(np.float32))
    close(tsp.dense_matmul_plain(cut, D), tsp.dense_matmul_plain(side, D))
    acc = torch.ones(side.rows, 9)
    assert tsp.dense_matmul(cut, D, acc) is acc
    close(acc, tsp.dense_matmul_plain(side, D).numpy() + 1)


def _tf32(a):
    """``a`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on
    10 mantissa bits, ties away from zero (the dense kernel's split)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(A, B, passes):
    """``A @ B`` from TF32 operands, as the dense kernel computes it: three
    passes ``lo.hi' + hi.lo' + hi.hi'`` (the small terms first), or the one
    pass ``hi.hi'``.  Products of TF32 values are exact in float32."""
    ah, bh = _tf32(A), _tf32(B)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(A - ah), _tf32(B - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("operands", ["store_blocks", "spread"])
def test_three_tf32_passes_hold_float32_accuracy(operands):
    """The 3xTF32 split, emulated in float32 on the CPU, within the card's
    tolerance (2e-5 of ``max|want|`` against float64); one TF32 pass is not,
    so the check is sharp.  On store-shaped operands (a panel's dense blocks,
    summed block by block, times its D panels) and on values spread over
    1e-3 .. 1e3."""
    rng = np.random.default_rng(13)
    if operands == "store_blocks":
        Xd, (r, c, v), opts = _case("all_classes_natural")
        side = build_tiled(r, c, v, Xd.shape, device="cpu", **opts).fwd
        ptr = side.dpanel_ptr.numpy()
        panel = int(np.argmax(np.diff(ptr)))
        blocks = side.dpanel_blocks[ptr[panel]:ptr[panel + 1]].long()
        assert len(blocks) >= 2
        D = torch.from_numpy(rng.random((side.n_colpanels * TILE, 16)).astype(np.float32))
        pairs = [(side.dvals[b].T.contiguous(),
                  D[int(side.dblk_panel[b // DENSE_GROUP]) * TILE:][:TILE]) for b in blocks]
    else:
        spread = lambda shape: torch.from_numpy((10 ** rng.uniform(-3, 3, shape)).astype(np.float32))
        pairs = [(spread((TILE, TILE)), spread((TILE, 16))) for _ in range(3)]
    want = sum(A.double() @ B.double() for A, B in pairs)
    scale = float(want.abs().max())
    for passes, holds in ((3, True), (1, False)):
        got = torch.zeros(TILE, 16)
        for A, B in pairs:
            got += _tf32_product(A, B, passes)
        err = float((got.double() - want).abs().max()) / scale
        assert (err <= 2e-5) == holds, (passes, err)


@pytest.mark.parametrize("bad, exc", [
    (lambda s: torch.zeros(s.cols, 8, dtype=torch.float64), TypeError),
    (lambda s: torch.zeros(s.cols + 1, 8), ValueError),
    (lambda s: torch.zeros(8, s.cols).T, ValueError),
    (lambda s: torch.zeros(s.cols), ValueError),
])
def test_wrappers_check_their_operand(bad, exc):
    Xd, (r, c, v), opts = _case("all_classes_natural")
    side = build_tiled(r, c, v, Xd.shape, device="cpu", **opts).fwd
    for fn in (tsp.chunk_matmul, tsp.dense_matmul):
        with pytest.raises(exc):
            fn(side, bad(side))
    with pytest.raises(ValueError, match="out must be"):
        tsp.dense_matmul(side, torch.zeros(side.cols, 8), torch.zeros(3, 8))


# ---------------------------------------------------------------------------
# the quad-tail store and wide tail tiles

# under jit, one computation: the products of a quad store chain three Pallas
# calls with sums between them, and eager dispatch beside an interpret-mode
# call still in flight can deadlock
jax_tiled_mm = jax.jit(jsp.tiled_mm)
jax_tiled_mtm = jax.jit(jsp.tiled_mtm)


def quad_close(got, want):
    """The limits the JAX package's own quad-store tests use."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-5, atol=2e-4)


@pytest.mark.parametrize("name", sorted(QUAD_CASES))
@pytest.mark.parametrize("k", [8, 9])
def test_mm_mtm_on_quad_and_wide_stores_match_jax_and_dense(name, k):
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **QUAD_CASES[name])
    Xj = jax_build_tiled(r, c, v, Xd.shape, **QUAD_CASES[name])
    assert Xt.fwd.n_qchunks > 0 or Xt.fwd.span > 1
    rng = np.random.default_rng(7)
    D = rng.random((Xd.shape[1], k)).astype(np.float32)
    D2 = rng.random((Xd.shape[0], k)).astype(np.float32)
    got = tsp.tiled_mm(Xt, torch.from_numpy(D))
    assert got.dtype == torch.float32 and tuple(got.shape) == (Xd.shape[0], k)
    quad_close(got, Xd @ D)
    quad_close(got, jax_tiled_mm(Xj, jnp.asarray(D)))
    got2 = tsp.tiled_mtm(Xt, torch.from_numpy(D2))
    quad_close(got2, Xd.T @ D2)
    quad_close(got2, jax_tiled_mtm(Xj, jnp.asarray(D2)))
    # and through the seam, on a store whose values were refreshed
    Y = matops.scale_values(Xt, matops.nnz_values(Xt) * 2.0)
    quad_close(matops.mm(Y, torch.from_numpy(D)) / 2, Xd @ D)
    quad_close(matops.mm(Xt.slim(), torch.from_numpy(D)), Xd @ D)


def test_quad_cases_hold_what_their_names_say():
    def side(name):
        Xd = four_class_matrix()
        return build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **QUAD_CASES[name]).fwd

    s = side("four_classes_natural")
    assert s.panel_chunks.numel() and s.n_dblocks and s.n_qchunks and s.n_coo
    ptr = s.qpanel_ptr.numpy()
    pps = s.panels_per_stripe
    assert ptr[pps] == 0 and ptr[-1] > 0  # no quad tile in the first stripe
    assert s.rows % TILE and s.cols % TILE  # the last panels are cut
    assert ptr[-1] > ptr[-2]  # and the cut row panel holds quad tiles
    s = side("quad_and_chunks")
    assert s.n_qchunks and not s.n_dblocks and not s.n_coo
    s = side("one_stripe_full_chunks")
    nper = TILE // s.quad_seg
    filled = (s.qvals.reshape(-1, nper, s.quad_seg) != 0).any(2).sum(1)
    assert int(filled.max()) == nper  # chunks with every sub-segment in use
    assert side("seg16_natural").quad_seg == 16
    assert side("span4_dense_band").span == 4


def _numpy_quad_loop(side, D):
    pps, seg = side.panels_per_stripe, side.quad_seg
    nper = TILE // seg
    out = np.zeros((side.n_stripes * pps * TILE, D.shape[1]), np.float64)
    for sg in side.qpanel_segs.tolist():
        ch, si = divmod(sg, nper)
        w = ch // QUAD_GROUP
        r0 = (int(side.qwin_stripe[w]) * pps + int(side.q_rp[sg])) * TILE
        c0 = int(side.qwin_panel[w]) * TILE
        for s in range(si * seg, (si + 1) * seg):
            val = float(side.qvals[ch, s])
            if val:
                out[r0 + int(side.qlrows[ch, s])] += val * D[c0 + int(side.qlcols[ch, s])]
    return out[: side.rows]


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("name", ["four_classes_natural", "seg16_degree"])
def test_quad_matmul_plain_against_a_loop_over_sub_segments(name, which):
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **QUAD_CASES[name])
    side = getattr(Xt, which)
    D = np.random.default_rng(2).random((side.cols, 9)).astype(np.float32)
    Dt = torch.from_numpy(D)
    quad = tsp.quad_matmul_plain(side, Dt)
    assert tuple(quad.shape) == (side.rows, 9)
    close(quad, _numpy_quad_loop(side, D))
    # the four classes partition the matrix
    rest = tsp.chunk_matmul_plain(side, Dt) + tsp.dense_matmul_plain(side, Dt)
    rest = tsp.coo_matmul(side, Dt, rest)
    if Xt.row_perm is None:
        close(rest + quad, (Xd if which == "fwd" else Xd.T) @ D)
    # the wrapper takes the plain version on the CPU and counts no launch
    before = build.launch_counts()
    assert torch.equal(tsp.quad_matmul(side, Dt), quad)
    acc = torch.ones(side.rows, 9)
    assert tsp.quad_matmul(side, Dt, acc) is acc
    close(acc, quad.numpy() + 1)
    assert build.launch_counts() == before and before["quad_matmul"] == 0


def test_quad_product_streams_in_pieces(monkeypatch):
    Xd = four_class_matrix()
    Xt = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **QUAD_BUILD)
    D = torch.from_numpy(np.random.default_rng(5).random((Xd.shape[1], 8)).astype(np.float32))
    whole = tsp.quad_matmul_plain(Xt.fwd, D)
    monkeypatch.setattr(tsp, "_PIECE", 4)  # one quad chunk at a time
    assert Xt.fwd.n_qchunks > 2
    close(tsp.quad_matmul_plain(Xt.fwd, D), whole)


@pytest.mark.parametrize("bad, exc", [
    (lambda s: torch.zeros(s.cols, 8, dtype=torch.float64), TypeError),
    (lambda s: torch.zeros(s.cols + 1, 8), ValueError),
    (lambda s: torch.zeros(8, s.cols).T, ValueError),
    (lambda s: torch.zeros(s.cols), ValueError),
])
def test_quad_matmul_checks_its_operand(bad, exc):
    Xd = four_class_matrix()
    side = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **QUAD_BUILD).fwd
    with pytest.raises(exc):
        tsp.quad_matmul(side, bad(side))
    with pytest.raises(ValueError, match="out must be"):
        tsp.quad_matmul(side, torch.zeros(side.cols, 8), torch.zeros(3, 8))
