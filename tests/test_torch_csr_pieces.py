"""A general sparse X's rows cut into pieces (``csr_piece_index``) and the
general-CSR product's plain version, which follows the kernel's order: each
piece summed from zero in CSR order, a split row's partial sums added in
piece order.  Held against a numpy model of the cut and of the order (bit
for bit in float32), against the JAX package's BCOO product (float64,
``rtol=1e-12``), and against the band's order for rows of one piece."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from nmf_tpu.ops import matops as jm
from nmf_tpu_torch.ops import matops as tm
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.sparse_format import (CSR_PIECE_ENTRIES, SparseCSR,
                                             csr_piece_index)

F64 = dict(rtol=1e-12, atol=1e-13)
# row lengths from empty to many times a cap of 4
LENGTHS = [0, 1, 3, 4, 5, 0, 8, 9, 17, 30, 2, 0, 12, 4, 25]


def ragged_matrix(lengths=LENGTHS, n=40, seed=3, dtype=np.float64):
    """A dense (len(lengths), n) array whose row r holds ``lengths[r]``
    entries at random columns."""
    rng = np.random.default_rng(seed)
    X = np.zeros((len(lengths), n), dtype)
    for r, m in enumerate(lengths):
        X[r, rng.choice(n, m, replace=False)] = rng.random(m) + 0.1
    return X


def recut(A, cap):
    """``A`` with both orientations' rows cut again at ``cap``."""
    return dataclasses.replace(
        A, fwd=dataclasses.replace(A.fwd, **csr_piece_index(A.fwd.crow, cap)),
        bwd=dataclasses.replace(A.bwd, **csr_piece_index(A.bwd.crow, cap)))


def model_pieces(lengths, cap):
    """The cut, one row at a time: (first entry, row) of every piece, then
    each piece's slot (-1 alone in its row) and each split row's slots."""
    starts, rows, pos = [], [], 0
    for r, m in enumerate(lengths):
        for j in range(0, max(m, 1), cap):
            starts.append(pos + j)
            rows.append(r)
        pos += m
    per = np.bincount(rows, minlength=len(lengths))
    part, slot = [], 0
    for r in rows:
        part.append(slot if per[r] > 1 else -1)
        slot += per[r] > 1
    split_row = np.flatnonzero(per > 1)
    split_ptr = np.concatenate([[0], np.cumsum(per[split_row])])
    return dict(piece_ptr=starts + [pos], piece_row=rows, piece_part=part,
                split_ptr=split_ptr.tolist(), split_row=split_row.tolist(),
                n_parts=int(split_ptr[-1]))


def model_product(X, D, cap):
    """``X @ D`` in float32 in the kernel's order, one row at a time."""
    out = np.zeros((X.shape[0], D.shape[1]), np.float32)
    for r in range(X.shape[0]):
        cols = np.flatnonzero(X[r])
        sums = []
        for j in range(0, max(len(cols), 1), cap):
            acc = np.zeros(D.shape[1], np.float32)
            for c in cols[j : j + cap]:
                acc = acc + X[r, c] * D[c]
            sums.append(acc)
        out[r] = sums[0]
        for s in sums[1:]:
            out[r] = out[r] + s
    return out


@pytest.mark.parametrize("cap", [1, 4, 7, 64])
def test_piece_index_follows_a_numpy_model_of_the_cut(cap):
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(LENGTHS)]))
    got = csr_piece_index(crow.to(torch.int32), cap)
    want = model_pieces(LENGTHS, cap)
    assert got["n_parts"] == want["n_parts"]
    for name in ("piece_ptr", "piece_row", "piece_part", "split_ptr", "split_row"):
        assert got[name].dtype == torch.int32, name
        assert got[name].tolist() == want[name], name
    with pytest.raises(ValueError, match="at least one entry"):
        csr_piece_index(crow, 0)
    empty = csr_piece_index(torch.zeros(1, dtype=torch.int32))
    assert empty["piece_ptr"].tolist() == [0] and empty["n_parts"] == 0


@pytest.mark.parametrize("cap", [1, 4, 64])
def test_plain_product_follows_the_kernels_order_bit_for_bit(cap):
    X = ragged_matrix(dtype=np.float32)
    D = np.random.default_rng(0).random((X.shape[1], 9), dtype=np.float32)
    A = recut(SparseCSR.from_torch_sparse(torch.from_numpy(X).to_sparse_csr()), cap)
    got = tsp.csr_matmul_plain(A.fwd, torch.from_numpy(D))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), model_product(X, D, cap))


@pytest.mark.parametrize("cap", [2, 4, CSR_PIECE_ENTRIES])
def test_products_over_pieces_match_the_jax_bcoo_branch(cap):
    X = ragged_matrix()
    A = recut(tm.as_operand(torch.from_numpy(X).to_sparse_coo()), cap)
    Xb = jsparse.BCOO.fromdense(jnp.asarray(X))
    rng = np.random.default_rng(1)
    D, Dt = rng.random((X.shape[1], 6)), rng.random((5, X.shape[0]))
    np.testing.assert_allclose(tm.mm(A, torch.from_numpy(D)).numpy(),
                               np.asarray(jm.mm(Xb, jnp.asarray(D))), **F64)
    np.testing.assert_allclose(tm.mtm(torch.from_numpy(Dt), A).numpy(),
                               np.asarray(jm.mtm(jnp.asarray(Dt), Xb)), **F64)
    if cap < max(LENGTHS):
        assert A.fwd.n_parts and A.bwd.n_parts


def test_rows_of_one_piece_keep_the_bands_bits():
    X = ragged_matrix(dtype=np.float32)
    A = SparseCSR.from_torch_sparse(torch.from_numpy(X).to_sparse_csr())
    D = torch.from_numpy(np.random.default_rng(2).random((X.shape[1], 7), dtype=np.float32))
    band = tsp._rows_summed(A.fwd.row, A.fwd.col, A.fwd.val, D,
                            torch.zeros(X.shape[0], 7))
    assert torch.equal(tsp.csr_matmul_plain(A.fwd, D), band)
    cut = recut(A, 4).fwd
    got = tsp.csr_matmul_plain(cut, D)
    short = torch.tensor(LENGTHS) <= 4
    assert torch.equal(got[short], band[short])
    np.testing.assert_allclose(got.numpy(), band.numpy(), rtol=1e-6, atol=1e-6)


def test_with_values_and_transpose_keep_the_pieces():
    X = ragged_matrix()
    A = recut(SparseCSR.from_torch_sparse(torch.from_numpy(X).to_sparse_csr()), 4)
    B = A.with_values(A.values * 3)
    T = A.transpose()
    fields = ("piece_ptr", "piece_row", "piece_part", "split_ptr", "split_row")
    for name in fields:
        assert getattr(B.fwd, name) is getattr(A.fwd, name)
        assert getattr(B.bwd, name) is getattr(A.bwd, name)
        assert getattr(T.fwd, name) is getattr(A.bwd, name)
        assert getattr(T.bwd, name) is getattr(A.fwd, name)
    assert (B.fwd.n_parts, T.fwd.n_parts) == (A.fwd.n_parts, A.bwd.n_parts)
    D = np.random.default_rng(3).random((X.shape[0], 5))
    np.testing.assert_allclose(tm.mm(T, torch.from_numpy(D)).numpy(), X.T @ D, **F64)
    Dn = np.random.default_rng(4).random((X.shape[1], 5))
    np.testing.assert_allclose(tm.mm(B, torch.from_numpy(Dn)).numpy(), 3 * X @ Dn, **F64)


def test_the_container_cuts_at_the_module_cap():
    lengths = [3, CSR_PIECE_ENTRIES, 0, 2 * CSR_PIECE_ENTRIES + 5, 1]
    X = ragged_matrix(lengths, n=3 * CSR_PIECE_ENTRIES)
    A = SparseCSR.from_torch_sparse(torch.from_numpy(X).to_sparse_csr())
    want = model_pieces(lengths, CSR_PIECE_ENTRIES)
    assert A.fwd.piece_row.tolist() == want["piece_row"] == [0, 1, 2, 3, 3, 3, 4]
    assert A.fwd.split_row.tolist() == [3] and A.fwd.n_parts == 3
    assert A.fwd.piece_ptr.tolist() == want["piece_ptr"]
    assert A.bwd.n_parts == 0  # no column holds more than five entries
    D = np.random.default_rng(5).random((X.shape[1], 4))
    np.testing.assert_allclose(tm.mm(A, torch.from_numpy(D)).numpy(), X @ D, **F64)


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_checks():
    X = ragged_matrix()
    A = SparseCSR.from_torch_sparse(torch.from_numpy(X).to_sparse_csr())
    D = torch.from_numpy(np.random.default_rng(6).random((X.shape[1], 3)))
    build.reset_launch_counts()
    assert torch.equal(tsp.csr_matmul(A.fwd, D), tsp.csr_matmul_plain(A.fwd, D))
    assert sum(build.launch_counts().values()) == 0
    with pytest.raises(ValueError, match=r"\(40, k\)"):
        tsp.csr_matmul(A.fwd, D[:-1])
