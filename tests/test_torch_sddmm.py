"""The sampled product ``(W @ H)`` at X's pattern of the PyTorch build on the
CPU, where the chunk kernel's wrapper runs its plain version: against the JAX
package's Pallas ``tiled_sddmm`` (interpret mode) and against the dense
``W @ H`` at the pattern.

Tolerance: ``rtol=2e-5`` with ``atol=1e-5 * max|want|`` — every side sums
the same k float32 products, in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmf_tpu.ops.pallas import sparse as jsp
from nmf_tpu.ops.sparse_format import build_tiled as jax_build_tiled
from nmf_tpu_torch import convert
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.sparse_format import DENSE_GROUP, QUAD_GROUP, TILE, build_tiled

from torch_parity import (BUILD, DENSE_NNZ, QUAD_BUILD, QUAD_CASES, coo_of,
                          four_class_matrix, jax_tiled_to_dict, three_class_matrix)

# under jit, one computation: eager dispatch beside an interpret-mode Pallas
# call still in flight can deadlock
jax_tiled_sddmm = jax.jit(jsp.tiled_sddmm)

CASES = {
    "chunks_only_natural": dict(stripe_tiles=2, group=8, order="natural"),
    "chunks_only_degree": dict(stripe_tiles=2, group=8, order="degree"),
    "with_dense_blocks": dict(stripe_tiles=2, group=8, dense_tile_nnz=DENSE_NNZ),
    "with_band": dict(stripe_tiles=2, group=8, coo_tail_nnz=40),
    "all_classes_natural": dict(BUILD, order="natural"),
    "all_classes_degree": dict(BUILD, order="degree"),
    "band_and_dense": dict(stripe_tiles=2, group=8, dense_tile_nnz=DENSE_NNZ,
                           coo_tail_nnz=DENSE_NNZ - 1),
}


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=2e-5, atol=1e-5 * np.abs(want).max()
    )


def _factors(shape, k, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.random((shape[0], k)).astype(np.float32),
            rng.random((k, shape[1])).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("k", [5, 9])
def test_tiled_sddmm_matches_jax_and_dense(name, k):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **CASES[name])
    Xj = jax_build_tiled(r, c, v, Xd.shape, **CASES[name])
    W, H = _factors(Xd.shape, k)
    got = tsp.tiled_sddmm(Xt, torch.from_numpy(W), torch.from_numpy(H))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(v),)
    close(got, (W.astype(np.float64) @ H)[r, c])
    close(got, jax_tiled_sddmm(Xj, jnp.asarray(W), jnp.asarray(H)))
    # the seam's gather form (the CPU route) gives the same vector
    close(matops.sddmm(torch.from_numpy(W), torch.from_numpy(H), Xt), got)


def test_store_classes_of_the_cases():
    def classes(name):
        Xd = three_class_matrix()
        s = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **CASES[name]).fwd
        return (s.panel_chunks.numel() > 0, s.n_dblocks > 0, s.n_coo > 0)

    assert classes("chunks_only_natural") == (True, False, False)
    assert classes("with_dense_blocks") == (True, True, False)
    assert classes("with_band") == (True, False, True)
    assert classes("all_classes_degree") == (True, True, True)
    assert classes("band_and_dense") == (False, True, True)


def test_a_store_carried_over_from_jax_samples_the_same_vector():
    """``convert.tiled_from_numpy`` carries the per-nnz arrays (values,
    row_idx, col_idx, perm, refresh maps): both packages' sampled products
    come out aligned, entry for entry."""
    Xd = three_class_matrix(2)
    r, c, v = coo_of(Xd)
    Xj = jax_build_tiled(r, c, v, Xd.shape, **BUILD)
    Xc = convert.tiled_from_numpy(jax_tiled_to_dict(Xj), device="cpu")
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    for name in ("values", "row_idx", "col_idx"):
        np.testing.assert_array_equal(getattr(Xc, name).numpy(), np.asarray(getattr(Xj, name)))
    for side_c, side_j, side_t in ((Xc.fwd, Xj.fwd, Xt.fwd), (Xc.bwd, Xj.bwd, Xt.bwd)):
        for name in ("perm", "inv", "dense_nnz", "dense_slot", "coo_nnz"):
            np.testing.assert_array_equal(
                getattr(side_c, name).numpy(), np.asarray(getattr(side_j, name)))
            np.testing.assert_array_equal(
                getattr(side_c, name).numpy(), getattr(side_t, name).numpy())
    W, H = _factors(Xd.shape, 7)
    want = np.asarray(jax_tiled_sddmm(Xj, jnp.asarray(W), jnp.asarray(H)))
    close(tsp.tiled_sddmm(Xc, torch.from_numpy(W), torch.from_numpy(H)), want)
    np.testing.assert_array_equal(
        tsp.tiled_sddmm(Xc, torch.from_numpy(W), torch.from_numpy(H)).numpy(),
        tsp.tiled_sddmm(Xt, torch.from_numpy(W), torch.from_numpy(H)).numpy(),
    )


def test_renumbered_store_skips_its_permutation():
    """In a renumbered solve the tiling's perms are stripped and the factors
    are already permuted: the sampled product must not permute again."""
    Xd = three_class_matrix(1)
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    assert Xt.row_perm is not None
    W, H = (torch.from_numpy(a) for a in _factors(Xd.shape, 6))
    Xr, Wr, Hr, _ = tcommon.renumbered_problem(Xt, W, H)
    assert Xr.row_perm is None and Xr.col_perm is None
    want = tsp.tiled_sddmm(Xt, W, H)
    assert torch.equal(tsp.tiled_sddmm(Xr, Wr, Hr), want)
    # and the gather form reads the renumbered CSR coordinates
    close(matops.sddmm(Wr, Hr, Xr), want)


def _numpy_slot_loop(side, W, Ht):
    pps = side.panels_per_stripe
    coords, inv = side.coords.numpy(), side.inv.numpy().reshape(-1, TILE)
    nnz = side.perm.shape[0]
    out = np.zeros(coords.shape, np.float64)
    for ch in range(coords.shape[0]):
        w = ch // side.group
        r0 = (int(side.win_stripe[w]) * pps + int(side.chunk_rp[ch])) * TILE
        c0 = int(side.win_panel[w]) * TILE
        for s in np.flatnonzero(inv[ch] < nnz):
            co = coords[ch, s]
            out[ch, s] = W[r0 + (co & 127)].astype(np.float64) @ Ht[c0 + (co >> 7)]
    return out.reshape(-1)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_plain_versions_against_store_loops(which):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **dict(BUILD, order="natural"))
    side = getattr(Xt, which)
    rng = np.random.default_rng(4)
    W = rng.random((side.rows, 9)).astype(np.float32)
    Ht = rng.random((side.cols, 9)).astype(np.float32)
    Wt, Htt = torch.from_numpy(W), torch.from_numpy(Ht)
    chunk = tsp.chunk_sddmm_plain(side, Wt, Htt)
    close(chunk, _numpy_slot_loop(side, W, Ht))
    # padding slots give exactly 0
    pad = side.inv.numpy() >= side.perm.shape[0]
    assert pad.any() and not chunk.numpy()[pad].any()
    # dense store: block b holds (W_panel @ Ht_panel')' in (col, row) layout
    WH = W.astype(np.float64) @ Ht.T
    dense = tsp.dense_sample(side, Wt, Htt).numpy().reshape(-1, TILE, TILE)
    pps = side.panels_per_stripe
    for b in side.dpanel_blocks.tolist():
        w = b // DENSE_GROUP
        r0 = (int(side.dblk_stripe[w]) * pps + int(side.dblk_rp[b])) * TILE
        c0 = int(side.dblk_panel[w]) * TILE
        want = WH[r0 : r0 + TILE, c0 : c0 + TILE]
        close(dense[b, : want.shape[1], : want.shape[0]], want.T)
    close(tsp.coo_sample(side, Wt, Htt),
          WH[side.coo_rows.numpy(), side.coo_cols.numpy()])
    # the wrapper takes the plain version on the CPU and counts no launch
    before = build.launch_counts()
    assert torch.equal(tsp.chunk_sddmm(side, Wt, Htt), chunk)
    out = torch.full((chunk.numel(),), 7.0)
    assert tsp.chunk_sddmm(side, Wt, Htt, out) is out and torch.equal(out, chunk)
    assert build.launch_counts() == before and before["chunk_sddmm"] == 0


def test_sampling_streams_in_pieces(monkeypatch):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    W, H = (torch.from_numpy(a) for a in _factors(Xd.shape, 8))
    whole = tsp.tiled_sddmm(Xt, W, H)
    monkeypatch.setattr(tsp, "_PIECE", 4)  # one chunk / block, 4 band entries
    assert Xt.fwd.n_coo > 4 and Xt.fwd.n_dblocks > 1
    close(tsp.tiled_sddmm(Xt, W, H), whole)


def test_float64_factors_come_back_float64():
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    W, H = (torch.from_numpy(a).double() for a in _factors(Xd.shape, 5))
    got = tsp.tiled_sddmm(Xt, W, H)
    assert got.dtype == torch.float64
    close(got, (W.numpy() @ H.numpy())[r, c])


@pytest.mark.parametrize("bad, exc", [
    (lambda s: (torch.zeros(s.rows, 8, dtype=torch.float64), torch.zeros(s.cols, 8)), TypeError),
    (lambda s: (torch.zeros(s.rows + 1, 8), torch.zeros(s.cols, 8)), ValueError),
    (lambda s: (torch.zeros(s.rows, 8), torch.zeros(s.cols, 7)), ValueError),
    (lambda s: (torch.zeros(8, s.rows).T, torch.zeros(s.cols, 8)), ValueError),
    (lambda s: (torch.zeros(s.rows, 0), torch.zeros(s.cols, 0)), ValueError),
])
def test_chunk_sddmm_checks_its_operands(bad, exc):
    Xd = three_class_matrix()
    side = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **BUILD).fwd
    with pytest.raises(exc):
        tsp.chunk_sddmm(side, *bad(side))
    with pytest.raises(ValueError, match="out must be"):
        tsp.chunk_sddmm(side, torch.zeros(side.rows, 8), torch.zeros(side.cols, 8),
                        torch.zeros(3))


def test_slimmed_store_is_refused():
    Xd = three_class_matrix()
    Xt = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **BUILD)
    W, H = (torch.from_numpy(a) for a in _factors(Xd.shape, 4))
    with pytest.raises(ValueError, match="slim"):
        tsp.tiled_sddmm(Xt.slim(), W, H)
    # a store without the refresh map but with perm is refused too
    half = dataclasses.replace(Xt, fwd=dataclasses.replace(Xt.fwd, inv=None))
    with pytest.raises(ValueError, match="slim"):
        tsp.tiled_sddmm(half, W, H)


# ---------------------------------------------------------------------------
# the quad-tail store and wide tail tiles


@pytest.mark.parametrize("name", sorted(QUAD_CASES))
@pytest.mark.parametrize("k", [5, 8])
def test_tiled_sddmm_on_quad_and_wide_stores_matches_jax_and_dense(name, k):
    """``rtol=3e-5, atol=1e-4``: the JAX package's own limits for this
    product on a quad store."""
    Xd = four_class_matrix()
    r, c, v = coo_of(Xd)
    Xt = build_tiled(r, c, v, Xd.shape, device="cpu", **QUAD_CASES[name])
    Xj = jax_build_tiled(r, c, v, Xd.shape, **QUAD_CASES[name])
    W, H = _factors(Xd.shape, k)
    got = tsp.tiled_sddmm(Xt, torch.from_numpy(W), torch.from_numpy(H))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(v),)
    np.testing.assert_allclose(got.numpy(), (W.astype(np.float64) @ H)[r, c],
                               rtol=3e-5, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_tiled_sddmm(Xj, jnp.asarray(W), jnp.asarray(H))),
        rtol=3e-5, atol=1e-4)
    close(matops.sddmm(torch.from_numpy(W), torch.from_numpy(H), Xt), got)


def _numpy_quad_slot_loop(side, W, Ht):
    pps, seg = side.panels_per_stripe, side.quad_seg
    nper = TILE // seg
    qinv = side.qinv.numpy().reshape(-1, TILE)
    nnz = side.perm.shape[0]
    out = np.zeros(qinv.shape, np.float64)
    for ch in range(side.n_qchunks):
        w = ch // QUAD_GROUP
        c0 = int(side.qwin_panel[w]) * TILE
        for s in np.flatnonzero(qinv[ch] < nnz):
            rp = int(side.q_rp[ch * nper + s // seg])
            r0 = (int(side.qwin_stripe[w]) * pps + rp) * TILE
            out[ch, s] = (W[r0 + int(side.qlrows[ch, s])].astype(np.float64)
                          @ Ht[c0 + int(side.qlcols[ch, s])])
    return out.reshape(-1)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("name", ["four_classes_natural", "seg16_natural"])
def test_quad_sddmm_plain_against_a_loop_over_slots(name, which):
    Xd = four_class_matrix()
    Xt = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **QUAD_CASES[name])
    side = getattr(Xt, which)
    rng = np.random.default_rng(4)
    # no zero in the factors: a sample of position (0, 0) would show
    W = rng.random((side.rows, 9)).astype(np.float32) + 0.5
    Ht = rng.random((side.cols, 9)).astype(np.float32) + 0.5
    Wt, Htt = torch.from_numpy(W), torch.from_numpy(Ht)
    quad = tsp.quad_sddmm_plain(side, Wt, Htt)
    assert tuple(quad.shape) == (side.n_qchunks * TILE,)
    close(quad, _numpy_quad_slot_loop(side, W, Ht))
    # padding slots (most of the store) give exactly 0, stored entries do not
    pad = side.qinv.numpy() >= side.perm.shape[0]
    assert pad.mean() > 0.5 and not quad.numpy()[pad].any() and quad.numpy()[~pad].all()
    # the wrapper takes the plain version on the CPU and counts no launch
    before = build.launch_counts()
    assert torch.equal(tsp.quad_sddmm(side, Wt, Htt), quad)
    out = torch.full((quad.numel(),), 7.0)
    assert tsp.quad_sddmm(side, Wt, Htt, out) is out and torch.equal(out, quad)
    assert build.launch_counts() == before and before["quad_sddmm"] == 0


def test_quad_sddmm_checks_its_operands_and_the_store():
    Xd = four_class_matrix()
    Xt = build_tiled(*coo_of(Xd), Xd.shape, device="cpu", **QUAD_BUILD)
    side = Xt.fwd
    with pytest.raises(TypeError):
        tsp.quad_sddmm(side, torch.zeros(side.rows, 8, dtype=torch.float64),
                       torch.zeros(side.cols, 8))
    with pytest.raises(ValueError):
        tsp.quad_sddmm(side, torch.zeros(side.rows, 8), torch.zeros(side.cols, 7))
    with pytest.raises(ValueError, match="out must be"):
        tsp.quad_sddmm(side, torch.zeros(side.rows, 8), torch.zeros(side.cols, 8),
                       torch.zeros(3))
    W, H = (torch.from_numpy(a) for a in _factors(Xd.shape, 4))
    with pytest.raises(ValueError, match="slim"):
        tsp.tiled_sddmm(Xt.slim(), W, H)
    half = dataclasses.replace(Xt, fwd=dataclasses.replace(side, qinv=None))
    with pytest.raises(ValueError, match="slim"):
        tsp.tiled_sddmm(half, W, H)
