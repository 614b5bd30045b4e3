"""The port's tail utilities against the JAX package's: ``posneg`` and
``printf_mat`` (``utils/numeric.py``) on the same seeded arrays, the
printed text compared line for line, and ``warmup``
(``utils/precompile.py``) over the same grid of solves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.utils import precompile as jax_precompile
from nmf_tpu_torch.utils import precompile


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_posneg_matches_the_jax_package(dtype):
    a = np.random.default_rng(4).standard_normal((7, 5)).astype(dtype)
    a[0, 0], a[1, 1] = 0.0, -0.0
    ap, an = nt.posneg(torch.from_numpy(a))
    jp, jn = nmf_tpu.posneg(jnp.asarray(a))
    assert ap.dtype == an.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(ap.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(an.numpy(), np.asarray(jn))
    np.testing.assert_array_equal((ap - an).numpy(), a)


@pytest.mark.parametrize("make", ["tensor", "numpy"])
def test_printf_mat_prints_the_jax_package_text(capsys, make):
    a = np.random.default_rng(5).standard_normal((4, 3)) * 100
    nmf_tpu.printf_mat(a)
    want = capsys.readouterr().out.splitlines()
    nt.printf_mat(torch.from_numpy(a) if make == "tensor" else a)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == 4 and got == want


def test_warmup_runs_the_jax_package_grid():
    assert precompile._ALGS == jax_precompile._ALGS
    assert precompile._INITS == jax_precompile._INITS
    assert nt.warmup(device="cpu") == 31
