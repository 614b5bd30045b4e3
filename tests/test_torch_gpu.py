"""Tests of the PyTorch/CUDA build that need a CUDA device: the hand-written
kernels against their plain versions, and the card against the CPU on a small
solve.  They skip without a device (a CUDA kernel has no interpret mode).

This file imports neither ``jax`` nor the JAX package, so it also runs where
only PyTorch is installed::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch.ops.cuda import sparse as tsp
from nmf_tpu_torch.ops.sparse_format import build_tiled

from torch_parity import BUILD, coo_of, three_class_matrix

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
    tsp.reset_launch_counts()
    for side in (Xt.fwd, Xt.bwd):
        D = torch.rand(side.cols, k, device=card)
        close(tsp.chunk_matmul(side, D), tsp.chunk_matmul_plain(side, D))
        close(tsp.dense_matmul(side, D), tsp.dense_matmul_plain(side, D))
        acc = torch.ones(side.rows, k, device=card)
        assert tsp.dense_matmul(side, D, acc) is acc
        close(acc, tsp.dense_matmul_plain(side, D) + 1)
    assert tsp.launch_counts() == {"chunk_matmul": 2, "dense_matmul": 4}
    D = torch.rand(Xd.shape[1], k, device=card)
    close(tsp.tiled_mm(Xt, D), torch.from_numpy(Xd).to(card) @ D)
    D2 = torch.rand(Xd.shape[0], k, device=card)
    close(tsp.tiled_mtm(Xt, D2), torch.from_numpy(Xd).to(card).T @ D2)


def test_kernels_give_the_same_bits_from_run_to_run(card):
    Xd = three_class_matrix(1)
    r, c, v = coo_of(Xd)
    side = build_tiled(r, c, v, Xd.shape, device=card, **BUILD).fwd
    D = torch.rand(side.cols, 64, device=card)
    a = tsp.dense_matmul(side, D, tsp.chunk_matmul(side, D))
    b = tsp.dense_matmul(side, D, tsp.chunk_matmul(side, D))
    assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    side = build_tiled(r, c, v, Xd.shape, device=card, **BUILD).fwd
    with pytest.raises(ValueError, match="k must be in"):
        tsp.chunk_matmul(side, torch.zeros(side.cols, tsp.MAX_K + 1, device=card))
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
    tsp.reset_launch_counts()
    a = nt.nnmf(build_tiled(r, c, v, Xd.shape, **BUILD), 6, **kw)  # default device
    assert a.W.is_cuda and min(tsp.launch_counts().values()) > 0
    b = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD), 6,
                device="cpu", **kw)
    # products summed in another order, fed through 5 sweeps
    close(a.W, b.W, rtol=1e-4)
    close(a.H, b.H, rtol=1e-4)
    assert a.objvalue == pytest.approx(b.objvalue, rel=1e-4)
    assert a.niters == b.niters == 5
