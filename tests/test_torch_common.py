"""The shared skeleton of the PyTorch build against the JAX package's:
convergence test, Result contract, size check, renumbering."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nmf_tpu.models import common as jcommon
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.ops.sparse_format import build_tiled
from nmf_tpu_torch.utils import dtypes as tdtypes
from nmf_tpu_torch.utils import numeric as tnumeric
from nmf_tpu.utils import dtypes as jdtypes

from torch_parity import BUILD, coo_of, three_class_matrix


def _factors(seed, p=40, n=30, k=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.random((p, k)).astype(dtype), rng.random((k, n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("step, tol", [
    (1e-3, 1e-2), (1e-3, 1e-4), (1e-1, 1e-2), (0.0, 1e-30), (1e-5, 1e-30),
])
def test_stop_condition_matches_jax(dtype, step, tol):
    W, H = _factors(0, dtype=dtype)
    rng = np.random.default_rng(1)
    preW = (W * (1 + step * rng.standard_normal(W.shape))).astype(dtype)
    preH = (H * (1 + step * rng.standard_normal(H.shape))).astype(dtype)
    cj, dj = jcommon.stop_condition(
        jnp.asarray(W), jnp.asarray(preW), jnp.asarray(H), jnp.asarray(preH), tol
    )
    ct, dt = tcommon.stop_condition(
        *(torch.from_numpy(a) for a in (W, preW, H, preH)), tol
    )
    assert bool(ct) == bool(cj)
    assert dt.dtype == torch.from_numpy(W).dtype
    # same sums in another order: 1e-6 relative
    np.testing.assert_allclose(float(dt), float(dj), rtol=1e-6, atol=1e-12)


def test_stop_condition_zero_columns_are_guarded():
    W = torch.zeros(4, 2)
    H = torch.zeros(2, 3)
    conv, dev = tcommon.stop_condition(W, W, H, H, 1e-3)
    assert bool(conv) and float(dev) == 0.0


def test_result_equality_hash_and_trace_exclusion():
    W, H = _factors(2)
    a = tcommon.Result(torch.from_numpy(W), torch.from_numpy(H), 3, True, 1.5)
    b = tcommon.Result(torch.from_numpy(W.copy()), torch.from_numpy(H.copy()), 3, True, 1.5,
                       trace=tcommon.Trace(torch.zeros(3), torch.zeros(3)))
    assert a == b and hash(a) == hash(b)
    assert isinstance(a.niters, int) and isinstance(a.converged, bool)
    assert isinstance(a.objvalue, float)
    for other in (
        tcommon.Result(torch.from_numpy(W + 1), torch.from_numpy(H), 3, True, 1.5),
        tcommon.Result(torch.from_numpy(W), torch.from_numpy(H), 4, True, 1.5),
        tcommon.Result(torch.from_numpy(W), torch.from_numpy(H), 3, False, 1.5),
        tcommon.Result(torch.from_numpy(W), torch.from_numpy(H), 3, True, 2.5),
    ):
        assert a != other
    assert a != "something else"
    assert "niters=3" in repr(a) and "(40, 5)" in repr(a)
    # same hash as the JAX package's Result on the same numbers
    j = jcommon.Result(jnp.asarray(W), jnp.asarray(H), 3, True, 1.5)
    assert hash(j) == hash(a)
    with pytest.raises(ValueError, match="Inner dimensions"):
        tcommon.Result(torch.zeros(4, 2), torch.zeros(3, 5), 0, False, 0.0)


def test_nmf_checksize():
    X = torch.zeros(6, 7)
    assert tcommon.nmf_checksize(X, torch.zeros(6, 2), torch.zeros(2, 7)) == (6, 7, 2)
    for W, H in ((torch.zeros(5, 2), torch.zeros(2, 7)),
                 (torch.zeros(6, 2), torch.zeros(3, 7)),
                 (torch.zeros(6, 2), torch.zeros(2, 6))):
        with pytest.raises(ValueError, match="inconsistent"):
            tcommon.nmf_checksize(X, W, H)


def test_renumbered_problem_round_trip():
    Xd = three_class_matrix()
    r, c, v = coo_of(Xd)
    X = build_tiled(r, c, v, Xd.shape, device="cpu", **BUILD)
    W, H = _factors(3, *Xd.shape, 6, np.float32)
    Wt, Ht = torch.from_numpy(W), torch.from_numpy(H)
    Xr, Wr, Hr, perms = tcommon.renumbered_problem(X, Wt, Ht)
    assert Xr.row_perm is None and Xr.col_rank is None and Xr.fwd is X.fwd
    np.testing.assert_array_equal(Wr.numpy(), W[X.row_perm.numpy()])
    np.testing.assert_array_equal(Hr.numpy(), H[:, X.col_perm.numpy()])
    # CSR-order coordinates moved into the renumbered space: same matrix
    Xperm = Xd[X.row_perm.numpy()][:, X.col_perm.numpy()]
    np.testing.assert_array_equal(
        Xperm[Xr.row_idx.numpy(), Xr.col_idx.numpy()], X.values.numpy()
    )
    W2, H2 = tcommon.unrenumber(Wr, Hr, perms)
    assert torch.equal(W2, Wt) and torch.equal(H2, Ht)
    # the product in renumbered coordinates is the permuted product
    from nmf_tpu_torch.ops import matops

    got = matops.mm(Xr, Hr.T.contiguous()).numpy()
    want = matops.mm(X, Ht.T.contiguous()).numpy()[X.row_perm.numpy()]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5 * np.abs(want).max())


def test_registry_rejects_unknown_options():
    class Nope:
        pass

    with pytest.raises(TypeError, match="No solver registered"):
        tcommon._impl_for(Nope())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dtype_constants_match_jax(dtype):
    td = torch.from_numpy(np.zeros(1, dtype)).dtype
    for name in ("eps", "cbrt_eps", "default_tol"):
        assert getattr(tdtypes, name)(td) == getattr(jdtypes, name)(dtype)
        assert getattr(tdtypes, name)(dtype) == getattr(jdtypes, name)(dtype)
    with pytest.raises(TypeError):
        tdtypes.eps(torch.int32)


def test_numeric_helpers():
    A = torch.tensor([[1.0, -2.0], [3.0, 4.0]])
    assert torch.equal(tnumeric.projectnn(A), torch.tensor([[1.0, 0.0], [3.0, 4.0]]))
    assert torch.allclose(tnumeric.normalize1_cols(A.abs()).sum(0), torch.ones(2))
    assert torch.allclose(tnumeric.normalize1(A.abs()).sum(), torch.tensor(1.0))
    assert torch.equal(tnumeric.adddiag(A, 2.0), A + 2 * torch.eye(2))
    with pytest.raises(ValueError):
        tnumeric.adddiag(torch.zeros(2, 3), 1.0)
    out = tnumeric.safe_div(torch.tensor([1.0, 0.0, 2.0]), torch.tensor([2.0, 0.0, 0.0]))
    assert torch.equal(out, torch.tensor([0.5, 0.0, 0.0]))
