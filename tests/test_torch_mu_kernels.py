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
from nmf_tpu_torch.ops.cuda import hals
from nmf_tpu_torch.ops.cuda import mu as tmu
from nmf_tpu_torch.ops.cuda import objectives as tobj
from nmf_tpu_torch.ops.cuda import sparse as tsp

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
    Hl, Gl, Cl = H.T[None], G[None], (X.T @ W)[None]
    assert torch.equal(hals.hals_sweep(Hl.clone(), Gl, Cl, range(6)),
                       hals.hals_sweep_plain(Hl.clone(), Gl, Cl, range(6)))
    assert build.launch_counts() == before
    assert set(before) == {"chunk_matmul", "dense_matmul", "quad_matmul",
                           "coo_matmul", "csr_matmul", "chunk_sddmm", "quad_sddmm",
                           "mu_factor_update", "wtq", "qht", "dense_objective",
                           "projectnn", "colsum", "scale_cols", "hals_sweep"}
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
    assert (tmu.MU_SLAB, tmu.QT_SLAB) == (64, 64)
    with pytest.raises(ValueError, match="k must be at least 1"):
        tmu.check_dense_problem(torch.zeros(4, 400), torch.zeros(4, 0),
                                torch.zeros(0, 400), "wtq")


def _with_headers(source, seen=None):
    """The text of a source and of the port's headers it includes, each
    once."""
    seen = set() if seen is None else seen
    seen.add(source)
    text = (CSRC / source).read_text()
    for header in re.findall(r'#include\s+"([^"]+)"', text):
        if header not in seen:
            text += _with_headers(header, seen)
    return text


def _shared_bytes(text, define):
    """The value of the shared-memory size ``define`` of a source, its
    operands taken from the numeric defines of the text."""
    numbers = dict(re.findall(r"#define\s+(\w+)\s+(\d+)\b", text))
    expr = re.search(rf"#define\s+{define}\s+(\(.*\))\s*$", text, re.M).group(1)
    expr = re.sub(r"[A-Za-z_]\w*", lambda m: numbers[m.group(0)], expr)
    assert re.fullmatch(r"[\d\s()+*]+", expr)
    return eval(expr)


@pytest.mark.parametrize("source, limit, smem", [
    ("mu.cu", (("MU_KS", "MU_SLAB"),), "QT_SMEM"),
    # wtq / qht / the objective: the slab depth, the output edge a block
    # owns, the walk's step
    ("quotient_tile.cuh", (("QT_KS", "QT_SLAB"), ("QT_L", "QT_EDGE"),
                           ("QT_S", "QT_STEP")), None),
    # the objective: its grid of QT_L columns a block, by which the wrapper
    # sizes the partials; its shared memory (the H slab, two W slabs, two X
    # tiles) within a block's
    ("objectives.cu", (("QT_L", "QT_EDGE"),), "OBJ_SMEM"),
    # mu_factor_update: its slab, the widest tile and the shared memory of a
    # block there and above a slab, which mu_smem repeats
    ("mu.cu", (("MU_KS", "MU_SLAB"),), "MU_SMEM"),
    # the sampled products' routine: the W panel it stages at most
    ("sddmm_piece.cuh", (), "SD_SMEM"),
])
def test_largest_k_stated_in_the_sources_is_the_wrappers(source, limit, smem):
    """No kernel states a largest k any more (any k fits: the reduction runs
    in slabs); the slab width and edges each source uses (itself or through
    the headers it includes) are the wrapper's, its shared memory fits a
    block's, and the notes of the three dense sources say that any k fits."""
    text = _with_headers(source)
    for define, name in limit:
        stated = re.findall(rf"#define\s+{define}\s+(\d+)", text)
        assert [int(v) for v in stated] == [getattr(tmu, name)]
    if smem is not None:
        assert 0 < _shared_bytes(text, smem) <= build.SMEM_PER_BLOCK
    if source == "objectives.cu":
        assert re.search(r"grid\(\(n \+ QT_L - 1\) / QT_L,", text)
    if smem == "MU_SMEM":
        stated = dict(re.findall(r"#define\s+(MU_BN|MU_LD)\s+(\d+)", text))
        assert int(stated["MU_BN"]) == max(tmu.MU_WIDTHS) == tmu.MU_WIDTHS[0]
        assert int(stated["MU_LD"]) == tmu.mu_smem(tmu.MU_SLAB, 0) // (4 * tmu.MU_SLAB)
        assert _shared_bytes(text, "MU_SMEM") == tmu.mu_smem(tmu.MU_SLAB, tmu.MU_WIDTHS[0])
        assert _shared_bytes(text, "MU_SMEM_SLABS") == tmu.mu_smem(tmu.MU_SLAB + 1,
                                                                   tmu.MU_WIDTHS[0])
        assert max(tmu.mu_smem(k, w) for k in range(1, 130) for w in tmu.MU_WIDTHS
                   if k <= tmu.MU_SLAB or w == tmu.MU_WIDTHS[0]) == max(
            _shared_bytes(text, "MU_SMEM"), _shared_bytes(text, "MU_SMEM_SLABS"))
        assert re.search(r"__launch_bounds__\(4 \* BN, 128 / BN\)", text)
    if smem == "SD_SMEM":
        stated = re.findall(r"#define\s+SD_STAGE_K\s+(\d+)", text)
        assert [int(v) for v in stated] == [tsp.SDDMM_STAGE_K]
    for src in ("mu.cu", "objectives.cu", "quotient_tile.cuh"):
        text = (CSRC / src).read_text().replace("//", "")
        assert not re.search(r"largest\s+k\s+is", text), src
        assert re.search(r"any\s+k\s+fits", text), src


# (owned, walked, k, multiprocessors, runs): the walks of the main path's
# dense problem (100,000 x 10,000, k 64), of ttt2 (2000 x 1000, k 32) and of
# chip_smoke.check_k_ceilings (300 x 260, k 183) on an H100's 132
# multiprocessors; the main path's wtq on a card with 114; an output of
# three waves with a thin last one
# (k, m, multiprocessors, columns a tile, blocks): kernel 7 at the main
# path's dense problem (the W step's 100,000 columns, the H step's 10,000, k
# 64), at ttt1 (500 x 500, k 8), at chip_smoke.check_k_ceilings (300 x 260,
# k 183 to 512: slabs), at the ragged edge checks, and on a card with 114
# multiprocessors
@pytest.mark.parametrize("k, m, sms, bn, blocks", [
    (64, 100_000, 132, 64, 264),   # 1,563 tiles, two blocks an SM resident
    (64, 10_000, 132, 32, 313),    # 157 tiles of 64 would leave the card idle
    (8, 500, 132, 16, 32),         # ttt1: a tile a block
    (183, 260, 132, 64, 15),       # 5 tiles x 3 row slabs
    (183, 300, 132, 64, 15),
    (512, 300, 132, 64, 40),
    (5, 777, 132, 16, 49),
    (64, 100_000, 114, 64, 228),
    (64, 10_000, 114, 32, 313),
])
def test_mu_tiling_rule(k, m, sms, bn, blocks):
    assert tmu.mu_tiling(k, m, sms) == (bn, blocks)
    units = -(-m // bn) * -(-k // tmu.MU_SLAB)
    threads = min(-(-k // 4), tmu.MU_SLAB // 4) * (bn // 4)
    per_sm = tmu.mu_blocks_per_sm(k, bn)
    assert per_sm * (tmu.mu_smem(k, bn) + 1024) <= tmu.SM_SHARED_BYTES
    assert per_sm * threads <= tmu.SM_THREADS
    # the launch bounds' blocks: 128 registers a thread at most
    assert per_sm * threads * 128 <= 65536
    assert blocks == min(units, sms * per_sm)
    # the widest tile that gives every multiprocessor two, the widest above
    # a slab; any width the kernel has may be asked for at k <= MU_SLAB
    wider = [w for w in tmu.MU_WIDTHS if w > bn]
    assert k > tmu.MU_SLAB or all(-(-m // w) < tmu.MU_TILES_PER_SM * sms for w in wider)
    assert 0 < tmu.mu_smem(k, bn) <= build.SMEM_PER_BLOCK
    if k <= tmu.MU_SLAB:
        assert [tmu.mu_tiling(k, m, sms, w)[0] for w in tmu.MU_WIDTHS] == list(tmu.MU_WIDTHS)
    else:
        with pytest.raises(ValueError, match="no tile"):
            tmu.mu_tiling(k, m, sms, 32)


@pytest.mark.parametrize("owned, walked, k, sms, runs", [
    (10_000, 100_000, 64, 132, 33),   # wtq: 40 blocks, 1,563 steps
    (100_000, 10_000, 64, 132, 1),    # qht: 391 blocks, 2.96 waves: no cut
    (1000, 2000, 32, 132, 32),        # ttt2 wtq: one run a step
    (2000, 1000, 32, 132, 16),        # ttt2 qht: one run a step
    (260, 300, 183, 132, 5),          # k_ceilings wtq: 2 x 3 blocks, 5 steps
    (300, 260, 183, 132, 5),          # k_ceilings qht
    (10_000, 100_000, 64, 114, 29),
    (270 * 256, 10_000, 64, 132, 5),  # 270 blocks: a last wave 6 blocks full
])
def test_walk_splits_rule(owned, walked, k, sms, runs):
    got = tmu.walk_splits(owned, walked, k, sms, tmu.QT_EDGE)
    assert got == runs
    blocks = -(-owned // tmu.QT_EDGE) * -(-k // tmu.QT_SLAB)
    steps = -(-walked // tmu.QT_STEP)
    # no cut, or enough blocks for the card, or one run a step; never an
    # empty run beyond what rounding the run to whole steps leaves
    assert got == 1 or blocks * got >= tmu.RUN_BLOCKS_PER_SM * sms or got == steps
    run = -(-steps // got)
    assert (got - 1) * run < steps


# (p, n, multiprocessors, runs): the objective's walk over the rows of the
# main path's dense problem, of ttt1 (500 x 500), of the edge and k-ceiling
# checks, and of a width whose 396 column panels make three full waves
@pytest.mark.parametrize("p, n, sms, runs", [
    (100_000, 10_000, 132, 33),   # 40 column panels, 1,563 steps
    (500, 500, 132, 8),           # ttt1: one run a step
    (1001, 777, 132, 16),
    (300, 260, 132, 5),
    (5000, 3 * 132 * 256, 132, 1),
])
def test_objective_walk_cut(p, n, sms, runs):
    """The objective kernel's grid: a block owns ``QT_EDGE`` columns and all
    of k (no component slabs), so its cut is that of an output of one
    component a column, whatever k; ``partial`` holds one double a block."""
    got = tobj.objective_splits(p, n, sms)
    assert got == runs
    assert got == tmu.walk_splits(n, p, 1, sms, tmu.QT_EDGE)
    steps = -(-p // tmu.QT_STEP)
    run = -(-steps // got)
    assert (got - 1) * run < steps  # no empty run beyond rounding
