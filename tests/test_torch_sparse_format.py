"""The PyTorch build's tiled store against the JAX package's, array by
array, from the same numpy input.  Integer arrays and values must be equal
exactly: both packages run the same binning arithmetic."""

import dataclasses

import numpy as np
import pytest
import torch

from nmf_tpu.ops import sparse_format as jsf
from nmf_tpu_torch import convert
from nmf_tpu_torch.ops import sparse_format as tsf

from torch_parity import (BUILD, QUAD_BUILD, coo_of, four_class_matrix,
                          jax_tiled_to_dict, three_class_matrix)

# per-side arrays shared by both stores (chunk_rp / dblk_rp / q_rp are
# byte-packed on the JAX side and compared after unpacking)
SIDE_ARRAYS = ("coords", "vals", "win_panel", "win_stripe", "perm", "inv",
               "dvals", "dblk_panel", "dblk_stripe", "dense_nnz", "dense_slot",
               "coo_rows", "coo_cols", "coo_vals", "coo_nnz")
QUAD_ARRAYS = ("qvals", "qlrows", "qlcols", "qwin_panel", "qwin_stripe", "qinv")
PACKED = ("chunk_rp", "dblk_rp", "q_rp")
SIDE_INTS = ("n_stripes", "n_colpanels", "n_windows", "group",
             "panels_per_stripe", "rows", "cols", "n_dblocks", "n_coo",
             "span", "n_qchunks", "quad_seg")
TOP_ARRAYS = ("row_idx", "col_idx", "values", "row_perm", "row_rank",
              "col_perm", "col_rank", "stats")


def _both(order, seed=0):
    Xd = three_class_matrix(seed)
    r, c, v = coo_of(Xd)
    Xj = jsf.build_tiled(r, c, v, Xd.shape, order=order, **BUILD)
    Xt = tsf.build_tiled(r, c, v, Xd.shape, order=order, device="cpu", **BUILD)
    return Xd, Xj, Xt


def _unpack(words):
    w = np.asarray(words).reshape(-1)
    return ((w[:, None] >> (8 * np.arange(4))) & 0xFF).reshape(-1)


def _assert_sides_equal(sj, st):
    for name in SIDE_INTS:
        assert getattr(sj, name) == getattr(st, name), name
    for name in SIDE_ARRAYS:
        a, b = getattr(sj, name), getattr(st, name)
        assert a is not None and b is not None, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    _assert_same_arrays(sj, st, PACKED[:2], unpack=True)


def _assert_same_arrays(sj, st, names, unpack=False):
    """Arrays of the two sides equal, or absent on both."""
    for name in names:
        a, b = getattr(sj, name), getattr(st, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = _unpack(a) if unpack else np.asarray(a)
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("order", ["degree", "natural"])
def test_build_tiled_equals_jax(order):
    _, Xj, Xt = _both(order)
    for side in (Xt.fwd, Xt.bwd):
        # all three store classes carry entries on both sides
        assert side.n_dblocks > 0 and side.n_coo > 0
        assert side.panel_chunks.numel() > 0 and side.dpanel_blocks.numel() > 0
    _assert_sides_equal(Xj.fwd, Xt.fwd)
    _assert_sides_equal(Xj.bwd, Xt.bwd)
    for name in TOP_ARRAYS:
        a, b = getattr(Xj, name), getattr(Xt, name)
        if order == "natural" and name.endswith(("perm", "rank")):
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert tuple(Xj.shape) == Xt.shape and Xj.build_opts == Xt.build_opts
    assert Xt.nnz == Xj.nnz and Xt.dtype == torch.float32 and Xt.ndim == 2


def test_row_panel_index_covers_every_entry_once():
    Xd, _, Xt = _both("natural")
    for side, M in ((Xt.fwd, Xd), (Xt.bwd, Xd.T)):
        pps = side.panels_per_stripe
        ptr = side.panel_ptr.numpy()
        chunks = side.panel_chunks.numpy()
        assert ptr[0] == 0 and ptr[-1] == len(chunks) == len(set(chunks))
        stripe = np.repeat(side.win_stripe.numpy()[:-1], side.group)
        panel = stripe * pps + side.chunk_rp.numpy()
        nnz_chunks = 0
        for r in range(len(ptr) - 1):
            mine = chunks[ptr[r]:ptr[r + 1]]
            assert (panel[mine] == r).all() and (np.diff(mine) > 0).all()
            nnz_chunks += int((side.vals.numpy()[mine] != 0).sum())
        # chunks left out of the index are all padding
        left = np.setdiff1d(np.arange(side.coords.shape[0]), chunks)
        assert not side.vals.numpy()[left].any()
        dptr = side.dpanel_ptr.numpy()
        blocks = side.dpanel_blocks.numpy()
        assert dptr[-1] == len(blocks) == len(set(blocks))
        dleft = np.setdiff1d(np.arange(side.n_dblocks), blocks)
        assert not side.dvals.numpy()[dleft].any()
        nnz_dense = int((side.dvals.numpy()[blocks] != 0).sum())
        assert nnz_chunks + nnz_dense + side.n_coo == (M != 0).sum()


# the pieces' fields of each class, in ``_cut_pieces``'s order
PIECE_FIELDS = ("piece_ptr", "piece_panel", "piece_part", "split_ptr", "split_panel",
                "n_parts")
QPIECE_FIELDS = ("qpiece_ptr", "qpiece_panel", "qpiece_part", "qsplit_ptr",
                 "qsplit_panel", "n_qparts")
DPIECE_FIELDS = ("dpiece_ptr", "dpiece_panel", "dpiece_part", "dsplit_ptr",
                 "dsplit_panel", "n_dparts")


def _piece_store(name, order):
    if name == "chunk":
        return _both(order)
    return _both_four(name, order)


def _check_pieces(side, cls, cap):
    """The pieces of one class ("chunk", "quad" or "dense"): each panel's
    list covered once and in order, cut greedily at ``cap`` entries (a dense
    block counts one); split panels' partials listed in piece order; the
    items' counts are their nonzero values, packed at the front."""
    h = lambda name: getattr(side, name).numpy() if isinstance(
        getattr(side, name), torch.Tensor) else getattr(side, name)
    if cls == "quad":
        ptr, items, nreal = h("qpanel_ptr"), h("qpanel_segs"), h("qseg_nreal")
        slots = side.qvals.numpy().reshape(-1, side.quad_seg)
        pp, pan, part, sptr, span, n_parts = map(h, QPIECE_FIELDS)
        keep = 0
    elif cls == "dense":
        ptr, items = h("dpanel_ptr"), h("dpanel_blocks")
        nreal = np.ones(side.n_dblocks, np.int64)
        pp, pan, part, sptr, span, n_parts = map(h, DPIECE_FIELDS)
        keep = 0
    else:
        ptr, items, nreal = h("panel_ptr"), h("panel_chunks"), h("chunk_nreal")
        slots = side.vals.numpy()
        pp, pan, part, sptr, span, n_parts = map(h, PIECE_FIELDS)
        keep = -(-side.rows // 128)
    if cls != "dense":
        live = slots != 0
        np.testing.assert_array_equal(nreal, live.sum(1))
        assert not (np.arange(slots.shape[1]) >= nreal[:, None])[live].any()
    assert pp[0] == 0 and pp[-1] == len(items) and (np.diff(pp) >= 0).all()
    assert (np.diff(pan) >= 0).all()
    entries = np.array([nreal[items[a:b]].sum() for a, b in zip(pp[:-1], pp[1:])])
    assert entries.max(initial=0) <= cap
    splits = []
    for r in range(len(ptr) - 1):
        mine = np.flatnonzero(pan == r)
        if ptr[r] == ptr[r + 1]:
            assert len(mine) == (r < keep) and entries[mine].sum() == 0
            continue
        assert pp[mine[0]] == ptr[r] and pp[mine[-1] + 1] == ptr[r + 1]
        assert (np.diff(mine) == 1).all()
        total = nreal[items[ptr[r]:ptr[r + 1]]].sum()
        assert (len(mine) == 1) == (total <= cap)
        # greedy: a piece ends where its panel's next item would not fit
        for p in mine[:-1]:
            assert entries[p] + nreal[items[pp[p + 1]]] > cap
        if len(mine) > 1:
            splits.append(r)
            assert (part[mine] == np.arange(len(mine)) + part[mine[0]]).all()
        else:
            assert part[mine[0]] == -1
    np.testing.assert_array_equal(span, splits)
    assert n_parts == (part >= 0).sum() == sptr[-1]
    np.testing.assert_array_equal(np.diff(sptr), np.bincount(pan)[splits])
    np.testing.assert_array_equal(np.sort(part[part >= 0]), np.arange(n_parts))


PIECE_STORES = ["chunk", "quad32_dense_band", "quad16", "span4_dense_band"]


@pytest.mark.parametrize("order", ["degree", "natural"])
@pytest.mark.parametrize("name", PIECE_STORES)
def test_pieces_cover_each_panel_once_within_the_cap(name, order):
    _, _, Xt = _piece_store(name, order)
    for side in (Xt.fwd, Xt.bwd):
        quad = side.qpanel_ptr is not None
        _check_pieces(side, "chunk", tsf.PIECE_ENTRIES)
        cut = tsf.recut_pieces(side, 128, side.quad_seg)
        _check_pieces(cut, "chunk", 128)
        assert cut.n_parts > 0 or side.panel_chunks.numel() < 2
        if quad:
            _check_pieces(side, "quad", tsf.PIECE_ENTRIES)
            _check_pieces(cut, "quad", side.quad_seg)
            assert cut.n_qparts > 0
        with pytest.raises(ValueError, match="largest item"):
            tsf.recut_pieces(side, int(side.chunk_nreal.max()) - 1)


@pytest.mark.parametrize("order", ["degree", "natural"])
@pytest.mark.parametrize("name", ["chunk", "quad32_dense_band", "span4_dense_band"])
def test_dense_pieces_cover_each_panel_once_within_the_cap(name, order):
    _, _, Xt = _piece_store(name, order)
    for side in (Xt.fwd, Xt.bwd):
        assert side.n_dblocks > 0 and side.dpanel_blocks.numel() > 0
        _check_pieces(side, "dense", tsf.DENSE_PIECE_BLOCKS)
        for cap in (1, 3):
            cut = tsf.recut_pieces(side, dcap=cap)
            _check_pieces(cut, "dense", cap)
            for name_ in PIECE_FIELDS:  # the other classes' pieces are kept
                assert getattr(cut, name_) is getattr(side, name_)
        # a cap of one block splits every panel of two or more blocks
        cut = tsf.recut_pieces(side, dcap=1)
        per_panel = side.dpanel_ptr.diff().numpy()
        np.testing.assert_array_equal(cut.dsplit_panel.numpy(),
                                      np.flatnonzero(per_panel >= 2))
        assert cut.n_dparts == per_panel[per_panel >= 2].sum()
        with pytest.raises(ValueError, match="largest item"):
            tsf.recut_pieces(side, dcap=0)


@pytest.mark.parametrize("name", ["chunk", "quad32_dense_band", "span2_band"])
def test_band_row_pointer_points_at_each_rows_entries(name):
    _, _, Xt = _piece_store(name, "degree")
    for side in (Xt.fwd, Xt.bwd):
        assert side.n_coo > 0
        ptr, rows = side.coo_ptr.numpy(), side.coo_rows.numpy()
        assert side.coo_ptr.dtype == torch.int32 and len(ptr) == side.rows + 1
        assert ptr[0] == 0 and ptr[-1] == side.n_coo and (np.diff(rows) >= 0).all()
        for r in np.unique(np.r_[rows, 0, side.rows - 1]):
            assert (rows[ptr[r]:ptr[r + 1]] == r).all()
            assert ptr[r + 1] - ptr[r] == (rows == r).sum()


def _pieces_product(side, D, quad):
    """The card's grouping on the CPU: each piece summed on its own in
    float32, entry by entry in store order, then a split panel's partial
    panels added in piece order (kernel 3 adds the result into zeros)."""
    h = lambda t: t.numpy()
    k = D.shape[1]
    if quad:
        seg = side.quad_seg
        nper = 128 // seg
        items, nreal = h(side.qpanel_segs), h(side.qseg_nreal)
        pp, pan, part, sptr, span, n_parts = (getattr(side, f) for f in QPIECE_FIELDS)
        chunk = items // nper
        base = chunk * 128 + (items % nper) * seg
        cbase = h(side.qwin_panel)[chunk // 8] * 128
        lrow, lcol = h(side.qlrows).ravel(), h(side.qlcols).ravel()
        val = h(side.qvals).ravel()
    else:
        items, nreal = h(side.panel_chunks), h(side.chunk_nreal)
        pp, pan, part, sptr, span, n_parts = (getattr(side, f) for f in PIECE_FIELDS)
        base = items * 128
        cbase = h(side.win_panel)[items // side.group] * side.span * 128
        co = h(side.coords).ravel()
        lrow, lcol, val = co & 127, co >> 7, h(side.vals).ravel()
    pp, pan, part, sptr, span = map(h, (pp, pan, part, sptr, span))
    out = np.zeros((side.rows, k), np.float32)
    parts = np.zeros((n_parts, 128, k), np.float32)
    for p in range(len(pan)):
        acc = np.zeros((128, k), np.float32)
        for i in range(pp[p], pp[p + 1]):
            s = np.arange(base[i], base[i] + nreal[items[i]])
            # np.add.at adds in index order, one entry after another
            np.add.at(acc, lrow[s], val[s, None] * D[cbase[i] + lcol[s]])
        if part[p] >= 0:
            parts[part[p]] = acc
        else:
            r0 = pan[p] * 128
            out[r0:r0 + 128] = acc[:len(out[r0:r0 + 128])]
    for s, r in enumerate(span):
        acc = parts[sptr[s]].copy()
        for q in range(sptr[s] + 1, sptr[s + 1]):
            acc += parts[q]
        out[r * 128:r * 128 + 128] = acc[:len(out[r * 128:r * 128 + 128])]
    return out


@pytest.mark.parametrize("name", PIECE_STORES)
def test_split_pieces_add_up_to_the_plain_product(name):
    from nmf_tpu_torch.ops.cuda import sparse as tsp

    _, _, Xt = _piece_store(name, "degree")
    rng = np.random.default_rng(6)
    for side in (Xt.fwd, Xt.bwd):
        D = rng.random((side.cols, 5), dtype=np.float32)
        want = tsp.chunk_matmul_plain(side, torch.from_numpy(D)).numpy()
        for s in (side, tsf.recut_pieces(side, 128, side.quad_seg)):
            got = _pieces_product(s, D, False)
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * np.abs(want).max())
        if side.qpanel_ptr is not None:
            want = tsp.quad_matmul_plain(side, torch.from_numpy(D)).numpy()
            cut = tsf.recut_pieces(side, None, side.quad_seg)
            assert cut.n_qparts > 0
            got = _pieces_product(cut, D, True)
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * np.abs(want).max())


def test_chunk_and_quad_products_refuse_misaligned_operands():
    """For an even k the kernels move float2: D and out must start on an
    8-byte boundary, which a view at an odd float offset misses."""
    from nmf_tpu_torch.ops.cuda import sparse as tsp

    side = _piece_store("quad32_dense_band", "degree")[2].fwd
    for k in (4, 5):
        flat = torch.rand(side.cols * k + 2, generator=torch.Generator().manual_seed(k))
        odd, even = flat[1:][: side.cols * k].view(-1, k), flat[2:].view(-1, k)
        out = torch.zeros(side.rows * k + 1)[1:].view(-1, k)
        if k % 2:
            assert torch.equal(tsp.chunk_matmul(side, odd),
                               tsp.chunk_matmul_plain(side, odd))
            tsp.quad_matmul(side, odd, out)
            continue
        with pytest.raises(ValueError, match="8-byte"):
            tsp.chunk_matmul(side, odd)
        with pytest.raises(ValueError, match="8-byte"):
            tsp.quad_matmul(side, even, out)
        assert torch.equal(tsp.chunk_matmul(side, even), tsp.chunk_matmul_plain(side, even))


def test_convert_gives_the_ports_own_store():
    _, Xj, Xt = _both("degree", seed=1)
    Xc = convert.tiled_from_numpy(jax_tiled_to_dict(Xj), device="cpu")
    assert Xc.shape == Xt.shape and Xc.build_opts == Xt.build_opts
    for name in TOP_ARRAYS:
        assert torch.equal(getattr(Xc, name), getattr(Xt, name)), name
    for sc, st in ((Xc.fwd, Xt.fwd), (Xc.bwd, Xt.bwd)):
        for f in dataclasses.fields(st):
            a, b = getattr(sc, f.name), getattr(st, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
            else:
                assert a == b, f.name
    # the index is also derivable from the stored values alone (slim stores)
    d = jax_tiled_to_dict(Xj.slim())
    Xs = convert.tiled_from_numpy(d, device="cpu")
    assert Xs.values is None and Xs.fwd.perm is None
    for ss, st in ((Xs.fwd, Xt.fwd), (Xs.bwd, Xt.bwd)):
        for name in ("panel_ptr", "panel_chunks", "dpanel_ptr", "dpanel_blocks",
                     "chunk_nreal", "coo_ptr", *PIECE_FIELDS, *DPIECE_FIELDS):
            a, b = getattr(ss, name), getattr(st, name)
            assert a == b if isinstance(b, int) else torch.equal(a, b), name


def test_factors_from_numpy():
    rng = np.random.default_rng(0)
    W, H = rng.random((7, 3)), rng.random((3, 5), dtype=np.float32)
    Wt, Ht = convert.factors_from_numpy(W, H, device="cpu")
    assert Wt.dtype == torch.float64 and Ht.dtype == torch.float32
    np.testing.assert_array_equal(Wt.numpy(), W)
    np.testing.assert_array_equal(Ht.numpy(), H)


def test_transpose_swaps_sides_and_perms():
    _, Xj, Xt = _both("degree")
    T = Xt.transpose()
    assert T.shape == (Xt.shape[1], Xt.shape[0])
    assert T.fwd is Xt.bwd and T.bwd is Xt.fwd
    assert T.row_idx is Xt.col_idx and T.row_perm is Xt.col_perm
    assert T.col_rank is Xt.row_rank
    _assert_sides_equal(Xj.transpose().fwd, T.fwd)


def test_with_values_round_trip_and_refresh():
    Xd, Xj, Xt = _both("degree")
    same = Xt.with_values(Xt.values)
    for a, b in ((same.fwd, Xt.fwd), (same.bwd, Xt.bwd)):
        assert torch.equal(a.vals, b.vals) and torch.equal(a.dvals, b.dvals)
        assert torch.equal(a.coo_vals, b.coo_vals)
    rng = np.random.default_rng(4)
    new = rng.random(Xt.nnz).astype(np.float32)
    Yt = Xt.with_values(torch.from_numpy(new))
    import jax.numpy as jnp

    Yj = Xj.with_values(jnp.asarray(new))
    for sj, st in ((Yj.fwd, Yt.fwd), (Yj.bwd, Yt.bwd)):
        for name in ("vals", "dvals", "coo_vals"):
            np.testing.assert_array_equal(
                np.asarray(getattr(sj, name)), getattr(st, name).numpy(), err_msg=name
            )
    # stats: sums taken in another order than jnp's
    np.testing.assert_allclose(Yt.stats.numpy(), np.asarray(Yj.stats), rtol=1e-5)


def test_slim_drops_refresh_maps_only():
    _, _, Xt = _both("degree")
    S = Xt.slim()
    assert S.values is None and S.row_idx is None and S.col_idx is None
    for a, b in ((S.fwd, Xt.fwd), (S.bwd, Xt.bwd)):
        for name in ("perm", "inv", "dense_nnz", "dense_slot", "coo_nnz"):
            assert getattr(a, name) is None
        for name in ("coords", "vals", "dvals", "coo_vals", "panel_chunks",
                     "dpanel_blocks", "chunk_nreal", "coo_ptr", *PIECE_FIELDS,
                     *DPIECE_FIELDS):
            assert getattr(a, name) is getattr(b, name)
    assert S.row_perm is Xt.row_perm and S.stats is Xt.stats
    with pytest.raises(ValueError, match="slim"):
        S.with_values(Xt.values)


# quad-tail and wide-tail stores: every class combination the JAX package's
# own tests build, on the matrix that fills all four classes
STORES = {
    "quad32": dict(quad_tail_nnz=32),
    "quad32_low_threshold": dict(quad_tail_nnz=8),
    "quad16": dict(quad_tail_nnz=16, quad_seg=16),
    "quad32_dense": dict(quad_tail_nnz=32, dense_tile_nnz=1000),
    "quad16_dense": dict(quad_tail_nnz=16, quad_seg=16, dense_tile_nnz=1000),
    "quad32_dense_band": dict(quad_tail_nnz=32, dense_tile_nnz=1000, coo_tail_nnz=2),
    "quad16_band": dict(quad_tail_nnz=12, quad_seg=16, coo_tail_nnz=2),
    "quad32_one_stripe": dict(quad_tail_nnz=32, stripe_tiles=32, group=16),
    "span2": dict(tail_span=2),
    "span2_band": dict(tail_span=2, coo_tail_nnz=3),
    "span4_dense_band": dict(tail_span=4, dense_tile_nnz=1000, coo_tail_nnz=2),
    "span16": dict(tail_span=16, dense_tile_nnz=1000),
}


def _both_four(name, order="degree", seed=0):
    Xd = four_class_matrix(seed)
    r, c, v = coo_of(Xd)
    kw = dict(dict(stripe_tiles=2, group=8), **STORES[name])
    Xj = jsf.build_tiled(r, c, v, Xd.shape, order=order, **kw)
    Xt = tsf.build_tiled(r, c, v, Xd.shape, order=order, device="cpu", **kw)
    return Xd, Xj, Xt


@pytest.mark.parametrize("name", sorted(STORES))
@pytest.mark.parametrize("order", ["degree", "natural"])
def test_quad_and_wide_stores_equal_jax(name, order):
    Xd, Xj, Xt = _both_four(name, order)
    for sj, st in ((Xj.fwd, Xt.fwd), (Xj.bwd, Xt.bwd)):
        for f in SIDE_INTS:
            assert getattr(sj, f) == getattr(st, f), f
        _assert_same_arrays(sj, st, SIDE_ARRAYS + QUAD_ARRAYS)
        _assert_same_arrays(sj, st, PACKED, unpack=True)
        if "quad" in name:
            assert st.n_qchunks > 0 and st.qpanel_segs.numel() > 0
            assert st.q_rp.shape == (st.n_qchunks * 128 // st.quad_seg,)
        else:
            assert st.span == STORES[name]["tail_span"] and st.qvals is None
    assert Xj.build_opts == Xt.build_opts
    # what was asked for is what the store holds
    f = Xt.fwd
    assert (f.n_dblocks > 0) == ("dense_tile_nnz" in STORES[name])
    assert (f.n_coo > 0) == ("coo_tail_nnz" in STORES[name])
    # the port's own store and the carried-over one are the same object, field
    # by field, the row-panel index over sub-segments included
    Xc = convert.tiled_from_numpy(jax_tiled_to_dict(Xj), device="cpu")
    for sc, st in ((Xc.fwd, Xt.fwd), (Xc.bwd, Xt.bwd)):
        for fld in dataclasses.fields(st):
            a, b = getattr(sc, fld.name), getattr(st, fld.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), fld.name
            else:
                assert a == b, fld.name


@pytest.mark.parametrize("name", ["quad32_dense_band", "quad16", "quad32_one_stripe"])
def test_quad_panel_index_covers_every_entry_once(name):
    Xd, _, Xt = _both_four(name, "natural")
    for side, M in ((Xt.fwd, Xd), (Xt.bwd, Xd.T)):
        seg, pps = side.quad_seg, side.panels_per_stripe
        nper = 128 // seg
        ptr, segs = side.qpanel_ptr.numpy(), side.qpanel_segs.numpy()
        assert ptr[0] == 0 and ptr[-1] == len(segs) == len(set(segs))
        assert len(ptr) == side.n_stripes * pps + 1
        stripe = np.repeat(side.qwin_stripe.numpy()[:-1], 8 * nper)
        panel = stripe * pps + side.q_rp.numpy()
        qv = side.qvals.numpy().reshape(-1, seg)
        dense = np.zeros(M.shape, np.float32)
        for r in range(len(ptr) - 1):
            mine = segs[ptr[r]:ptr[r + 1]]
            assert (panel[mine] == r).all() and (np.diff(mine) > 0).all()
            for sg in mine:
                ch, sl = divmod(int(sg), nper)
                sl = slice(sl * seg, (sl + 1) * seg)
                real = side.qvals[ch, sl].numpy() != 0
                rows = r * 128 + side.qlrows[ch, sl].numpy()[real]
                cols = int(side.qwin_panel[ch // 8]) * 128 + side.qlcols[ch, sl].numpy()[real]
                dense[rows, cols] += side.qvals[ch, sl].numpy()[real]
        # sub-segments left out hold nothing, and claim row panel 0
        left = np.setdiff1d(np.arange(qv.shape[0]), segs)
        assert len(left) > 0 and not qv[left].any()
        assert not side.q_rp.numpy()[left].any()
        # every entry with at most quad_tail_nnz neighbours in its tile, once
        quad_nnz = int((qv != 0).sum())
        assert (dense != 0).sum() == quad_nnz and (dense[dense != 0] == M[dense != 0]).all()
        nnz_chunks = int((side.vals.numpy() != 0).sum())
        nnz_dense = int((side.dvals.numpy() != 0).sum()) if side.n_dblocks else 0
        assert nnz_chunks + nnz_dense + quad_nnz + side.n_coo == (M != 0).sum()
        # a slimmed store gives the same index from its values alone
        f = {fld.name: getattr(side, fld.name) for fld in dataclasses.fields(side)}
        f = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in f.items()}
        f.update(perm=None, inv=None, qinv=None, dense_slot=None)
        again = tsf.row_panel_index(f)
        for fld in ("qpanel_ptr", "qpanel_segs", "qseg_nreal", *QPIECE_FIELDS):
            np.testing.assert_array_equal(again[fld], getattr(side, fld), err_msg=fld)


@pytest.mark.parametrize("name", ["quad32_dense_band", "quad16_dense", "span2_band"])
def test_with_values_and_slim_on_quad_and_wide_stores(name):
    import jax.numpy as jnp

    _, Xj, Xt = _both_four(name)
    new = np.random.default_rng(4).random(Xt.nnz).astype(np.float32)
    Yt = Xt.with_values(torch.from_numpy(new))
    Yj = Xj.with_values(jnp.asarray(new))
    for sj, st, s0 in ((Yj.fwd, Yt.fwd, Xt.fwd), (Yj.bwd, Yt.bwd, Xt.bwd)):
        _assert_same_arrays(sj, st, ("vals", "dvals", "qvals", "coo_vals"))
        assert st.qpanel_segs is s0.qpanel_segs and st.qlrows is s0.qlrows
    same = Xt.with_values(Xt.values)
    for a, b in ((same.fwd, Xt.fwd), (same.bwd, Xt.bwd)):
        assert torch.equal(a.vals, b.vals)
        assert a.qvals is None or torch.equal(a.qvals, b.qvals)
    S = Xt.slim()
    for a, b in ((S.fwd, Xt.fwd), (S.bwd, Xt.bwd)):
        assert a.qinv is None and a.perm is None and a.inv is None
        for fld in ("qvals", "qlrows", "qlcols", "q_rp", "qpanel_ptr", "qpanel_segs",
                    "coords", "qseg_nreal", *QPIECE_FIELDS):
            assert getattr(a, fld) is getattr(b, fld)
    with pytest.raises(ValueError, match="slim"):
        S.with_values(Xt.values)
    if Xt.fwd.n_qchunks:  # a store that lost only its quad refresh map
        half = dataclasses.replace(Xt, fwd=dataclasses.replace(Xt.fwd, qinv=None))
        with pytest.raises(ValueError, match="slim"):
            half.with_values(Xt.values)


@pytest.mark.parametrize("kw, exc", [
    (dict(tail_span=3), ValueError),
    (dict(tail_span=2, quad_tail_nnz=8), ValueError),
    (dict(quad_tail_nnz=33), ValueError),
    (dict(quad_tail_nnz=17, quad_seg=16), ValueError),
    (dict(quad_tail_nnz=0), ValueError),
    (dict(quad_seg=8), ValueError),
    (dict(layout="grid"), ValueError),
    (dict(coo_tail_nnz=0), ValueError),
    (dict(dense_tile_nnz=10, coo_tail_nnz=10), ValueError),
    (dict(group=12), ValueError),
])
def test_build_tiled_refuses(kw, exc):
    r, c, v = coo_of(three_class_matrix())
    with pytest.raises(exc):
        tsf.build_tiled(r, c, v, (300, 260), device="cpu", **kw)
    with pytest.raises(exc):  # the JAX package refuses the same inputs
        jsf.build_tiled(r, c, v, (300, 260), **kw)


def test_empty_matrix_builds():
    z = np.zeros(0, np.int32)
    Xt = tsf.build_tiled(z, z, np.zeros(0, np.float32), (200, 300), device="cpu")
    Xj = jsf.build_tiled(z, z, np.zeros(0, np.float32), (200, 300))
    assert Xt.fwd.n_windows == Xj.fwd.n_windows == 1
    assert Xt.fwd.panel_chunks.numel() == 0 and Xt.fwd.n_dblocks == 0
    np.testing.assert_array_equal(np.asarray(Xj.fwd.coords), Xt.fwd.coords.numpy())
