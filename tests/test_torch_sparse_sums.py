"""``matops.colsums`` / ``rowsums`` on the tiled store sum in a fixed order:
they are the store's products against a ones column (kernels 1-3 and the
band on the card, their plain versions here), with no ``index_add_``.

Parity: the JAX package's ``matops.colsums`` / ``rowsums`` on the same
numpy inputs (under ``jax.jit``), on a chunk store with dense tiles and a
band and on quad-tail stores, at ``rtol=1e-5``: both add float32 values in
float32, in other orders, over at most a few hundred entries a row or
column."""

import sys

import jax
import numpy as np
import pytest
import torch

from nmf_tpu.ops import matops as jmatops
from nmf_tpu.ops import sparse_format as jsf
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops import sparse_format as tsf
from torch_parity import (BUILD, QUAD_BUILD, coo_of, four_class_matrix,
                          three_class_matrix)

STORES = {
    "chunk_dense_band": (three_class_matrix, BUILD),
    "quad32": (four_class_matrix, QUAD_BUILD),
    "quad16": (four_class_matrix, dict(QUAD_BUILD, quad_tail_nnz=16, quad_seg=16)),
}
jax_colsums = jax.jit(jmatops.colsums)
jax_rowsums = jax.jit(jmatops.rowsums)


def _stores(name):
    make, opts = STORES[name]
    Xd = make(0)
    r, c, v = coo_of(Xd)
    Xj = jsf.build_tiled(r, c, v, Xd.shape, **opts)
    Xt = tsf.build_tiled(r, c, v, Xd.shape, device="cpu", **opts)
    return Xd, Xj, Xt


@pytest.mark.parametrize("name", sorted(STORES))
def test_store_sums_match_the_jax_package(name, monkeypatch):
    Xd, Xj, Xt = _stores(name)

    # matops itself adds nothing with index_add_ (the float atomics on the
    # card); the products' plain versions, which run here, still may
    index_add_ = torch.Tensor.index_add_

    def no_atomics(self, *args, **kwargs):
        if sys._getframe(1).f_globals["__name__"] == matops.__name__:
            raise AssertionError("matops summed with index_add_")
        return index_add_(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "index_add_", no_atomics)
    got_c, got_r = matops.colsums(Xt), matops.rowsums(Xt)
    assert got_c.shape == (Xd.shape[1],) and got_r.shape == (Xd.shape[0],)
    assert got_c.dtype == got_r.dtype == torch.float32
    np.testing.assert_allclose(got_c.numpy(), np.asarray(jax_colsums(Xj)), rtol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(jax_rowsums(Xj)), rtol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), Xd.sum(0, dtype=np.float64), rtol=1e-5)
    np.testing.assert_allclose(got_r.numpy(), Xd.sum(1, dtype=np.float64), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(STORES))
def test_a_slimmed_store_sums_the_same(name):
    """The sums read the store's own arrays, not the CSR-order ones that
    ``slim()`` drops, so a slimmed store sums to the same bits."""
    _, _, Xt = _stores(name)
    S = Xt.slim()
    assert S.values is None and S.col_idx is None and S.row_idx is None
    assert torch.equal(matops.colsums(S), matops.colsums(Xt))
    assert torch.equal(matops.rowsums(S), matops.rowsums(Xt))


def test_dense_x_keeps_its_own_sums():
    Xd = torch.from_numpy(three_class_matrix(1))
    assert torch.equal(matops.colsums(Xd), Xd.sum(dim=0))
    assert torch.equal(matops.rowsums(Xd), Xd.sum(dim=1))
