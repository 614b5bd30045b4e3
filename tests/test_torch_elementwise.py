"""The elementwise kernels' plain versions (kernels 10-12: ``projectnn``,
the column sums and the column scaling) against the JAX package's Pallas
kernels run in interpret mode, and the routing of ``utils.numeric`` to them.

Tolerances: ``projectnn`` is exact (``max`` rounds nothing), so it is held
with ``assert_array_equal``; ``normalize1_cols`` at ``rtol=1e-6``: the JAX
kernel adds the column in float32 in 512-row blocks, the plain version in
PyTorch's float32 order, and both divide once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nmf_tpu.ops.pallas.elementwise import normalize1_cols_pallas, projectnn_pallas
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import elementwise as tew
from nmf_tpu_torch.utils import numeric


@pytest.fixture(scope="module")
def A():
    rng = np.random.default_rng(1)
    return rng.standard_normal((130, 120)).astype(np.float32)


def test_projectnn_plain_matches_the_pallas_kernel(A):
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(projectnn_pallas(jnp.asarray(A)))
    got = tew.projectnn_plain(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(numeric.projectnn(torch.from_numpy(A)).numpy(), want)


def test_normalize1_cols_plain_matches_the_pallas_kernel(A):
    Apos = np.abs(A) + np.float32(0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(normalize1_cols_pallas(jnp.asarray(Apos)))
    t = torch.from_numpy(Apos)
    got = tew.scale_cols_plain(t, tew.colsum_plain(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(numeric.normalize1_cols(t).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(tew.colsum_plain(t).numpy(), Apos.sum(axis=0, dtype=np.float64),
                               rtol=1e-6)


def test_projectnn_plain_keeps_nan_and_zeros():
    a = np.array([[-0.0, 0.0, np.nan, -1.5], [np.inf, -np.inf, 2.0, -np.nan]], np.float32)
    got = tew.projectnn_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, np.maximum(a, np.float32(0)))
    assert np.isnan(got[0, 2]) and np.isnan(got[1, 3])
    # an entry is kept unless it is below zero: -0.0 stays -0.0, as clamp_min
    t = torch.from_numpy(a)
    assert torch.equal(torch.signbit(tew.projectnn_plain(t)), torch.signbit(t.clamp_min(0)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(dtype):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((37, 5))).to(dtype)
    build.reset_launch_counts()
    got = numeric.projectnn(a)
    pos = a.abs() + 0.5
    norm = numeric.normalize1_cols(pos)
    assert torch.equal(got, a.clamp_min(0)) and got.dtype == dtype
    assert torch.equal(norm, pos / pos.sum(dim=0, keepdim=True))
    assert torch.equal(tew.projectnn(a.T), a.T.clamp_min(0))
    assert not any(build.launch_counts().values())
    assert build._lib is None  # nothing was built either


def test_scale_cols_plain_is_ieee_division():
    rng = np.random.default_rng(3)
    a = rng.random((9, 6)).astype(np.float32)
    s = (rng.random(6) + 0.5).astype(np.float32)
    got = tew.scale_cols_plain(torch.from_numpy(a), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, a / s[None, :])
