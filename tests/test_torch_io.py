"""The PyTorch build's Matrix Market loader against the JAX package's numpy
route (``tests/test_io.py``): the parse, the CSR conversion's sorting and
summing of duplicates, and ``to_bcoo`` into a solve."""

import numpy as np
import pytest
import scipy.sparse
import torch

from nmf_tpu.io import loader as jl
import nmf_tpu_torch as nt
from nmf_tpu_torch.io import loader as tl


@pytest.fixture
def mtx_file(tmp_path):
    """The JAX package's fixture: 300 random entries of a 50 x 40 matrix,
    some of them at one position (duplicates), written by hand."""
    rng = np.random.default_rng(0)
    p, n, nnz = 50, 40, 300
    rows = rng.integers(0, p, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.random(nnz).astype(np.float32)
    path = tmp_path / "test.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("% a comment line\n")
        f.write(f"{p} {n} {nnz}\n")
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r+1} {c+1} {v:.8g}\n")
    dense = scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(p, n)).toarray()
    return path, dense


@pytest.fixture
def jax_numpy_route(monkeypatch):
    """The JAX package's loader without its native library: its numpy
    route (scipy's), whose arrays the port's host library gives."""
    monkeypatch.setattr(jl, "_LIB", None)
    monkeypatch.setattr(jl, "_LIB_TRIED", True)


def test_load_mtx(mtx_file, jax_numpy_route):
    path, dense = mtx_file
    coo = tl.load_mtx(str(path))
    want = jl.load_mtx(str(path))
    assert (coo.rows, coo.cols) == dense.shape == (want.rows, want.cols)
    for f in ("row_idx", "col_idx", "values"):
        got = getattr(coo, f)
        assert got.dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(got, getattr(want, f))
    got = np.zeros(dense.shape, np.float64)
    np.add.at(got, (coo.row_idx, coo.col_idx), coo.values.astype(np.float64))
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-7)


def test_coo_to_csr_dedupes_and_sorts(mtx_file, jax_numpy_route):
    path, dense = mtx_file
    csr = tl.coo_to_csr(tl.load_mtx(str(path)))
    want = jl.coo_to_csr(jl.load_mtx(str(path)))
    for f in ("indptr", "indices", "data"):
        assert getattr(csr, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(csr, f), getattr(want, f))
    m = scipy.sparse.csr_matrix((csr.data, csr.indices, csr.indptr),
                                shape=(csr.rows, csr.cols))
    np.testing.assert_allclose(m.toarray(), dense, rtol=1e-5, atol=1e-6)
    # strictly sorted, duplicate-free columns per row
    for r in range(csr.rows):
        assert (np.diff(csr.indices[csr.indptr[r] : csr.indptr[r + 1]]) > 0).all()


def test_to_bcoo_and_solve(mtx_file, jax_numpy_route):
    path, dense = mtx_file
    coo = tl.load_mtx(str(path))
    X = tl.to_bcoo(coo, device="cpu")
    want = jl.to_bcoo(jl.load_mtx(str(path)))
    assert X.layout == torch.sparse_coo and X.is_coalesced() and X.dtype == torch.float32
    np.testing.assert_array_equal(X.indices().numpy().T, np.asarray(want.indices))
    np.testing.assert_array_equal(X.values().numpy(), np.asarray(want.data))
    # a CSR goes the same way, and float64 on request
    X64 = tl.to_bcoo(tl.coo_to_csr(coo), dtype=torch.float64, device="cpu")
    assert X64.dtype == torch.float64
    assert torch.equal(X64.indices(), X.indices())
    ret = nt.nnmf(X, 4, alg="cd", init="random", maxiter=10, device="cpu")
    assert np.isfinite(ret.objvalue)
    assert ret == nt.nnmf(torch.from_numpy(dense.astype(np.float32)).to_sparse_csr(), 4,
                          alg="cd", init="random", maxiter=10, device="cpu")


def test_to_bcoo_defaults_to_the_card():
    coo = tl.COO(2, 2, np.array([0, 1], np.int32), np.array([1, 0], np.int32),
                 np.ones(2, np.float32))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tl.to_bcoo(coo)
