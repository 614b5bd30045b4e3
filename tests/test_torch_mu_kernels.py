"""The multiplicative-update and dense-objective kernels of the PyTorch build
on the CPU, where each wrapper runs its kernel's plain version: against the
JAX package's Pallas kernels (TPU interpret mode) on the same float32 inputs.

Tolerances are the ones ``tests/test_pallas.py`` holds the Pallas kernels to:
``rtol=2e-5`` for the factor update, ``3e-5`` for the quotient products,
``1e-5`` for the objectives — float32 sums taken in another order."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nmf_tpu.ops.pallas import mu as jmu
from nmf_tpu.ops.pallas import objectives as jobj
from nmf_tpu_torch.ops.cuda import build
from nmf_tpu_torch.ops.cuda import mu as tmu
from nmf_tpu_torch.ops.cuda import objectives as tobj

CSRC = pathlib.Path(tmu.__file__).resolve().parents[2] / "csrc"
DELTA = float(np.sqrt(np.finfo(np.float32).eps))

SHAPES = [(300, 280, 8), (130, 517, 5), (257, 64, 16)]


def _problem(p, n, k, seed=0, zeros=False):
    rng = np.random.default_rng(seed)
    X = rng.random((p, n)).astype(np.float32)
    if zeros:  # exact zeros: the KL term's x = 0 branch
        X[rng.random((p, n)) < 0.3] = 0.0
    W = rng.random((p, k)).astype(np.float32)
    H = rng.random((k, n)).astype(np.float32)
    return X, W, H


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("p, n, k", SHAPES)
@pytest.mark.parametrize("lam", [0.0, 0.01])
def test_mu_factor_update_matches_pallas(p, n, k, lam):
    X, W, H = _problem(p, n, k)
    G, C = W.T @ W, W.T @ X
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmu.mu_factor_update(
            jnp.asarray(H), jnp.asarray(G), jnp.asarray(C), lam, DELTA))
    got = tmu.mu_factor_update_plain(*_t(H, G, C), lam, DELTA)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)
    # the W step's orientation: transposed views in, the same layout out
    G2, C2 = H @ H.T, X @ H.T
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmu.mu_factor_update(
            jnp.asarray(W).T, jnp.asarray(G2), jnp.asarray(C2).T, lam, DELTA)).T
    Wt, G2t, C2t = _t(W, G2, C2)
    got = tmu.mu_factor_update(Wt.T, G2t, C2t.T, lam, DELTA).T
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


@pytest.mark.parametrize("p, n, k", SHAPES)
def test_wtq_qht_match_pallas(p, n, k):
    X, W, H = _problem(p, n, k, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want_wtq = np.asarray(jmu.wtq(*map(jnp.asarray, (X, W, H)), DELTA))
        want_qht = np.asarray(jmu.qht(*map(jnp.asarray, (X, W, H)), DELTA))
    Xt, Wt, Ht = _t(X, W, H)
    got_wtq, got_qht = tmu.wtq_plain(Xt, Wt, Ht, DELTA), tmu.qht_plain(Xt, Wt, Ht, DELTA)
    assert tuple(got_wtq.shape) == (k, n) and tuple(got_qht.shape) == (p, k)
    np.testing.assert_allclose(got_wtq.numpy(), want_wtq, rtol=3e-5)
    np.testing.assert_allclose(got_qht.numpy(), want_qht, rtol=3e-5)


@pytest.mark.parametrize("p, n, k", SHAPES)
@pytest.mark.parametrize("kind", ["mse", "kl"])
def test_objective_matches_pallas(p, n, k, kind):
    X, W, H = _problem(p, n, k, seed=2, zeros=kind == "kl")
    jfn = jobj.mse_objective_pallas if kind == "mse" else jobj.kl_objective_pallas
    with pltpu.force_tpu_interpret_mode():
        want = float(jfn(*map(jnp.asarray, (X, W, H))))
    got = tobj.dense_objective_plain(*_t(X, W, H), kind)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # float64 reference of the same formula
    WH = W.astype(np.float64) @ H
    if kind == "mse":
        ref = 0.5 * ((X - WH) ** 2).sum()
    else:
        pos = X > 0
        ref = (X[pos] * (np.log(X[pos]) - np.log(WH[pos])) - X[pos] + WH[pos]).sum() + WH[~pos].sum()
    np.testing.assert_allclose(float(got), ref, rtol=1e-5)


def test_plain_objective_runs_in_column_blocks(monkeypatch):
    X, W, H = _t(*_problem(90, 700, 4, seed=3, zeros=True))
    whole = {kind: float(tobj.dense_objective_plain(X, W, H, kind)) for kind in tobj.KINDS}
    monkeypatch.setattr(tobj, "_BLOCK_N", 64)  # 11 blocks, the last ragged
    for kind in tobj.KINDS:
        np.testing.assert_allclose(
            float(tobj.dense_objective_plain(X, W, H, kind)), whole[kind], rtol=1e-5)


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_no_launch():
    X, W, H = _t(*_problem(70, 90, 6, seed=4))
    G, C = W.T @ W, W.T @ X
    before = build.launch_counts()
    assert torch.equal(tmu.mu_factor_update(H, G, C, 0.1, DELTA),
                       tmu.mu_factor_update_plain(H, G, C, 0.1, DELTA))
    assert torch.equal(tmu.wtq(X, W, H, DELTA), tmu.wtq_plain(X, W, H, DELTA))
    assert torch.equal(tmu.qht(X, W, H, DELTA), tmu.qht_plain(X, W, H, DELTA))
    assert torch.equal(tobj.mse_objective_kernel(X, W, H),
                       tobj.dense_objective_plain(X, W, H, "mse"))
    assert torch.equal(tobj.kl_objective_kernel(X, W, H),
                       tobj.dense_objective_plain(X, W, H, "kl"))
    assert build.launch_counts() == before
    assert set(before) == {"chunk_matmul", "dense_matmul", "quad_matmul",
                           "coo_matmul", "chunk_sddmm", "quad_sddmm",
                           "mu_factor_update", "wtq", "qht", "dense_objective",
                           "projectnn", "colsum", "scale_cols"}
    assert not any(before.values())
    # float64 keeps its type through the plain versions
    Xd, Wd, Hd = X.double(), W.double(), H.double()
    assert tmu.wtq(Xd, Wd, Hd, DELTA).dtype == torch.float64
    assert tobj.kl_objective_kernel(Xd, Wd, Hd).dtype == torch.float64


def test_mu_factor_update_checks_its_operands():
    X, W, H = _t(*_problem(40, 50, 6, seed=5))
    G, C = W.T @ W, W.T @ X
    with pytest.raises(ValueError, match="inconsistent"):
        tmu.mu_factor_update(H, G[:, :5], C, 0.0, DELTA)
    with pytest.raises(ValueError, match="inconsistent"):
        tmu.mu_factor_update(H, G, C[:, :-1], 0.0, DELTA)
    with pytest.raises(TypeError, match="dtypes differ"):
        tmu.mu_factor_update(H, G.double(), C, 0.0, DELTA)


@pytest.mark.parametrize("make, exc, msg", [
    (lambda X, W, H: (X, W[:-1], H), ValueError, "inconsistent"),
    (lambda X, W, H: (X, W, H[:, :-1]), ValueError, "inconsistent"),
    (lambda X, W, H: (X, W.double(), H), TypeError, "W must be float32"),
    (lambda X, W, H: (X.T.contiguous().T, W, H), ValueError, "X must be contiguous"),
])
def test_dense_problem_check(make, exc, msg):
    X, W, H = make(*_t(*_problem(40, 52, 6, seed=6)))
    with pytest.raises(exc, match=msg):
        tmu.check_dense_problem(X, W, H, "wtq")


def test_dense_problem_check_settles_layout_and_vector_width():
    X, W, H = _t(*_problem(40, 52, 6, seed=6))
    p, n, k, Wc, Hc, xvec = tmu.check_dense_problem(
        X, W.T.contiguous().T, H, "wtq")
    assert (p, n, k, xvec) == (40, 52, 6, 1) and Wc.is_contiguous() and torch.equal(Wc, W)
    assert tmu.check_dense_problem(X[:, :51].contiguous(), W, H[:, :51], "wtq")[5] == 0
    # no ceiling on k: the kernels sum over k one slab at a time
    assert tmu.check_dense_problem(torch.zeros(4, 400), torch.zeros(4, 373),
                                   torch.zeros(373, 400), "wtq")[2] == 373
    assert (tmu.MU_SLAB, tmu.WH_SLAB) == (64, 128)
    with pytest.raises(ValueError, match="k must be at least 1"):
        tmu.check_dense_problem(torch.zeros(4, 400), torch.zeros(4, 0),
                                torch.zeros(0, 400), "wtq")


@pytest.mark.parametrize("source, limit", [
    ("mu.cu", (("MU_KS", "MU_SLAB"),)),
    ("wh_tile.cuh", (("WH_KS", "WH_SLAB"),)),
])
def test_largest_k_stated_in_the_sources_is_the_wrappers(source, limit):
    """No kernel states a largest k any more (any k fits: the reduction runs
    in slabs); the slab width each source defines is the wrapper's, and the
    notes of the three dense sources say that any k fits."""
    text = (CSRC / source).read_text()
    for define, name in limit:
        stated = re.findall(rf"#define\s+{define}\s+(\d+)", text)
        assert [int(v) for v in stated] == [getattr(tmu, name)]
    for src in ("mu.cu", "objectives.cu", "wh_tile.cuh"):
        text = (CSRC / src).read_text().replace("//", "")
        assert not re.search(r"largest\s+k\s+is", text), src
        assert re.search(r"any\s+k\s+fits", text), src
