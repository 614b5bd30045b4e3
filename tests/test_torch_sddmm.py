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
from nmf_tpu_torch.ops.sparse_format import (DENSE_GROUP, QUAD_GROUP, TILE, build_tiled,
                                             recut_pieces)

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


def _kernel_walk(side, W, Ht, quad=False):
    """What the sampled-product kernels (``csrc/sddmm_piece.cuh``) write, in
    numpy, over the chunks (kernel 4) or the quad sub-segments (kernel 5):
    a block a piece samples the real slots at the front of each of its items
    (``chunk_nreal`` / ``qseg_nreal``), the W row read through the piece's
    row panel, the column through the item's window, and zeroes the item's
    tail; the blocks past the pieces zero the items without entries.
    Checks on the way that a piece lists only items of its own row panel and
    that no entry lies past an item's front.  Returns (times each slot is
    written, the values in float64)."""
    nnz = side.perm.shape[0]
    if quad:
        seg = side.quad_seg
        nreal, ptr, items = (side.qseg_nreal.numpy(), side.qpiece_ptr.numpy(),
                             side.qpanel_segs.numpy())
        panels, inv = side.qpiece_panel.numpy(), side.qinv.numpy()
        lrows, lcols = side.qlrows.numpy().reshape(-1), side.qlcols.numpy().reshape(-1)
        stripe = side.qwin_stripe.numpy()[np.arange(len(nreal)) * seg // TILE // QUAD_GROUP]
        rp, win_panel, group, span = side.q_rp.numpy(), side.qwin_panel.numpy(), QUAD_GROUP, 1
    else:
        seg = TILE
        nreal, ptr, items = (side.chunk_nreal.numpy(), side.piece_ptr.numpy(),
                             side.panel_chunks.numpy())
        panels, inv = side.piece_panel.numpy(), side.inv.numpy()
        coords = side.coords.numpy().reshape(-1)
        lrows, lcols = coords & 127, coords >> 7
        stripe = side.win_stripe.numpy()[np.arange(len(nreal)) // side.group]
        rp, win_panel, group, span = (side.chunk_rp.numpy(), side.win_panel.numpy(),
                                      side.group, side.span)
    n_slots = len(nreal) * seg
    assert len(inv) == n_slots
    writes = np.zeros(n_slots, np.int64)
    out = np.zeros(n_slots, np.float64)
    for piece, panel in enumerate(panels):
        for c in items[ptr[piece]:ptr[piece + 1]]:
            assert stripe[c] * side.panels_per_stripe + rp[c] == panel
            first = c * seg
            assert (inv[first + nreal[c]:first + seg] >= nnz).all()
            writes[first:first + seg] += 1
            for slot in range(first, first + nreal[c]):
                row = int(panel) * TILE + int(lrows[slot])
                col = int(win_panel[first // TILE // group]) * span * TILE + int(lcols[slot])
                if inv[slot] < nnz and row < side.rows and col < side.cols:
                    out[slot] = W[row].astype(np.float64) @ Ht[col]
    for c in np.flatnonzero(nreal == 0):
        assert (inv[c * seg:(c + 1) * seg] >= nnz).all()
        writes[c * seg:(c + 1) * seg] += 1
    return writes, out


def _nearly_all_padding():
    """About five entries a 128 x 128 tile: every quad sub-segment holds a
    few entries at its front, most of each one and most chunks padding."""
    rng = np.random.default_rng(3)
    p, n = 200, 20_000
    key = np.unique(rng.integers(0, p, 1200) * n + rng.integers(0, n, 1200))
    return ((key // n).astype(np.int32), (key % n).astype(np.int32),
            (rng.random(len(key)) + 0.5).astype(np.float32), (p, n))


@pytest.mark.parametrize("name, build, cap", [
    ("natural", dict(BUILD, order="natural"), None),
    ("degree", dict(BUILD, order="degree"), None),
    ("span4", QUAD_CASES["span4_dense_band"], None),
    ("pieces_of_128", dict(BUILD, order="degree"), 128),
    # kernel 5 over the quad sub-segments
    ("quad32_natural", QUAD_CASES["four_classes_natural"], None),
    ("quad32_degree", QUAD_CASES["four_classes_degree"], None),
    ("quad16_natural", QUAD_CASES["seg16_natural"], None),
    ("quad16_degree", QUAD_CASES["seg16_degree"], None),
    # at most a sub-segment's worth of entries a piece: panels of 37 and 38
    # entries (seg 32), of 24 and 29 (seg 16) are cut
    ("quad32_pieces_of_32", QUAD_CASES["four_classes_degree"], 32),
    ("quad16_pieces_of_16", QUAD_CASES["seg16_natural"], 16),
    ("quad32_nearly_all_padding", dict(stripe_tiles=2, group=8, quad_tail_nnz=32,
                                       order="natural"), None),
])
def test_chunk_sddmm_kernel_walk_covers_every_slot_once(name, build, cap):
    """The host-side facts the sampled-product kernels stand on, over the
    chunks (kernel 4) and over the quad sub-segments (kernel 5, the
    ``quad`` cases): the pieces list every item with entries once and no
    other, an item's entries are its first ``chunk_nreal`` / ``qseg_nreal``
    slots, and the piece's row panel is the item's; so the walk writes every
    slot once and gives the plain version's values (padding slots 0),
    however the pieces are cut."""
    quad = name.startswith("quad")
    if name.endswith("nearly_all_padding"):
        r, c, v, shape = _nearly_all_padding()
    else:
        Xd = four_class_matrix() if name == "span4" or quad else three_class_matrix()
        (r, c, v), shape = coo_of(Xd), Xd.shape
    Xt = build_tiled(r, c, v, shape, device="cpu", **build)
    side = Xt.fwd
    if cap is not None:
        side = recut_pieces(side, qcap=cap) if quad else recut_pieces(side, cap)
    assert side.span == (4 if name == "span4" else 1)
    rng = np.random.default_rng(5)
    W = rng.random((side.rows, 7)).astype(np.float32)
    Ht = rng.random((side.cols, 7)).astype(np.float32)
    writes, out = _kernel_walk(side, W, Ht, quad)
    assert (writes == 1).all()
    plain = tsp.quad_sddmm_plain if quad else tsp.chunk_sddmm_plain
    want = plain(side, torch.from_numpy(W).double(), torch.from_numpy(Ht).double()).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
    pad = (side.qinv if quad else side.inv).numpy() >= side.perm.shape[0]
    assert pad.any() and not out[pad].any()
    if quad:
        assert side.quad_seg == (16 if "quad16" in name else 32)
        if cap is not None:  # some panel's sub-segments are cut into pieces
            assert side.qsplit_panel.numel() > 0
        if name.endswith("nearly_all_padding"):
            assert pad.mean() > 0.9 and (side.qseg_nreal.numpy() == 0).any()


@pytest.mark.parametrize("k, lanes", [
    (1, 1), (16, 1), (17, 2), (64, 4), (127, 8), (128, 8), (129, 16),
    (256, 16), (450, 32), (512, 32), (2000, 32),
])
def test_chunk_sddmm_lanes_a_slot(k, lanes):
    """A slot takes the least power of two of lanes that leaves each at most
    ``SDDMM_LANE_FLOATS`` products, at most a warp."""
    got = tsp.sddmm_lanes(k)
    assert got == lanes and got & (got - 1) == 0 and got <= 32
    assert got * tsp.SDDMM_LANE_FLOATS >= k or got == 32
