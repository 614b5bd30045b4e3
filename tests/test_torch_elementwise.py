"""The elementwise kernels' plain versions (kernels 10-12: ``projectnn``,
the column sums and the column scaling) against the JAX package's Pallas
kernels run in interpret mode, and the routing of ``utils.numeric`` to them.
Kernel 11's plan (``colsum_plan``: its grid, the rows a block takes, its
scratch) and its order of summation, emulated in numpy, which lies within 1
ulp of the exact column sums; the plan's constants are the source's.

Tolerances: ``projectnn`` is exact (``max`` rounds nothing), so it is held
with ``assert_array_equal``; ``normalize1_cols`` at ``rtol=1e-6``: the JAX
kernel adds the column in float32 in 512-row blocks, the plain version in
PyTorch's float32 order, and both divide once."""

import math
import re

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


# the paths' shapes (GreedyCD's factors and the normalised starts at ttt4 and
# at the dense problem), ragged ones, n above a block's threads, one row
PLAN_SHAPES = [(163_000, 128), (59_000, 128), (100_000, 64), (10_000, 64),
               (1, 1), (1, 512), (63, 3), (64, 4), (65, 127), (1000, 777),
               (9973, 450), (163_001, 512), (70, 1500)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("m, n", PLAN_SHAPES)
def test_colsum_plan_gives_every_row_to_one_block(m, n, sms):
    plan = tew.colsum_plan(m, n, sms)
    assert plan == tew.colsum_plan(m, n, sms)  # (m, n, sms) decide it alone
    assert 1 <= plan.blocks <= tew.COLSUM_BLOCKS_PER_SM * sms
    assert plan.scratch == plan.blocks * n + 1  # the partials, then the ticket
    starts = [b * plan.rows for b in range(plan.blocks)]
    ends = [min(m, s + plan.rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == m
    assert all(e == s for e, s in zip(ends, starts[1:]))  # in order, no gap
    assert all(s < e for s, e in zip(starts, ends))       # no block empty
    assert plan.blocks == 1 or plan.rows >= tew.COLSUM_MIN_ROWS


def test_colsum_plan_at_the_path_shape_and_its_refusals():
    # one block an SM on an H100 (132 SMs), 1,235 rows a block
    assert tew.colsum_plan(163_000, 128, 132) == (132, 1235, 132 * 128 + 1)
    assert tew.colsum_plan(1000, 777, 132).blocks == 1000 // tew.COLSUM_MIN_ROWS
    for bad in ((0, 4, 132), (4, 0, 132), (4, 4, 0)):
        with pytest.raises(ValueError, match="no column sums"):
            tew.colsum_plan(*bad)


def _colsum_in_the_kernels_order(A, sms, vec):
    """Kernel 11's additions in its order, in float64: each block's
    sub-rows (rows ``r0 + sub``, ``r0 + sub + R``, ...) in increasing row
    order, the sub-rows in order; then for each column the stripes of
    consecutive blocks, each in block order, the stripes in order; rounded
    once to float32."""
    m, n = A.shape
    T = tew.COLSUM_THREADS
    plan = tew.colsum_plan(m, n, sms)
    V = 4 if vec else 1
    units = n // V
    a = A.astype(np.float64)
    partial = np.empty((plan.blocks, n))
    for b in range(plan.blocks):
        r0, r1 = b * plan.rows, min(m, (b + 1) * plan.rows)
        for u0 in range(0, units, T):
            w = min(T, units - u0)
            R = T // w
            cols = slice(u0 * V, (u0 + w) * V)
            tot = np.zeros(w * V)
            for sub in range(R):
                s = np.zeros(w * V)
                for r in range(r0 + sub, r1, R):
                    s = s + a[r, cols]
                tot = tot + s
            partial[b, cols] = tot
    out = np.empty(n, np.float32)
    for c0 in range(0, n, T):
        w = min(T, n - c0)
        S = T // w
        per = -(-plan.blocks // S)
        tot = np.zeros(w)
        for st in range(S):
            s = np.zeros(w)
            for b in range(st * per, min(plan.blocks, (st + 1) * per)):
                s = s + partial[b, c0:c0 + w]
            tot = tot + s
        out[c0:c0 + w] = tot.astype(np.float32)
    return out


@pytest.mark.parametrize("m, n, sms, vec", [
    (1000, 128, 4, True), (1000, 128, 132, False), (9973, 64, 132, True),
    (777, 450, 7, False), (300, 3, 2, False), (1, 512, 132, True),
    (130, 1, 132, False), (200, 1500, 3, False), (4100, 4, 132, True),
])
def test_the_kernels_order_of_summation_is_within_one_ulp(m, n, sms, vec):
    """Every column within 1 ulp of the exact sum rounded to float32 (the
    entries are positive, as a factor's are)."""
    rng = np.random.default_rng(m + n)
    A = (rng.random((m, n)) + rng.random((m, n)) ** 8 * 100).astype(np.float32)
    got = _colsum_in_the_kernels_order(A, sms, vec)
    exact = np.array([math.fsum(col) for col in A.T.astype(np.float64)], np.float32)
    off = np.abs(got.view(np.int32).astype(np.int64) - exact.view(np.int32))
    assert off.max() <= 1


def test_colsum_constants_are_the_sources():
    text = (build.CSRC / "elementwise.cu").read_text()
    stated = dict(re.findall(r"#define\s+(COLSUM_\w+)\s+(\d+)", text))
    assert int(stated["COLSUM_NT"]) == tew.COLSUM_THREADS
    # the plan's blocks an SM are the launch bounds': ptxas keeps the loads
    # in flight in the registers that count leaves a thread
    assert int(stated["COLSUM_BPS"]) == tew.COLSUM_BLOCKS_PER_SM
    assert "__launch_bounds__(COLSUM_NT, COLSUM_BPS)" in text
    assert re.search(r"<<<blocks, COLSUM_NT, 0, st>>>", text)
    # what the wrapper allocates is what the entry point reads: the partials
    # of every block, then the ticket word
    assert "scratch + (size_t)blocks * n" in text
    assert "cudaMemsetAsync(ticket, 0, sizeof(unsigned), st)" in text
