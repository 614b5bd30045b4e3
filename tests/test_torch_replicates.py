"""Batched random restarts of the PyTorch build (``models/replicates.py``,
``nnmf(..., parallel_replicates=True)``) on the CPU: against the port's own
sequential restarts, and each lane against the JAX package's vmapped solve.

Tolerances (float64 but on the float32 store):

* lanes stepped by the solver's own ``update`` (MU, ProjectedALS,
  ALSPGrad) give the sequential bits: ``torch.equal``;
* Fast-HALS and GreedyCD lanes step together.  Their products with X run
  at width ``r * k``, whose columns have the bits of a product of width
  ``k`` on the store (each column is summed on its own), and their Grams
  and matrix-vector products are taken lane by lane, so on the store they
  give the sequential bits.  A dense X's wide product is one BLAS call,
  whose blocking may sum a column otherwise than the narrow one: there the
  factors and the objective are held to ``rtol=1e-9`` (a few ulps of
  float64 carried through a dozen iterations), and the iteration counts
  and flags must agree exactly;
* each lane against the JAX package's ``vmap`` of ``_solve_while`` from the
  same starts: ``rtol=1e-8, atol=1e-10``, as the single-solve parity tests
  of the port hold a solve after a few iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.models.common import _solve_while
from nmf_tpu_torch.models import interface
from nmf_tpu_torch.models import replicates as reps
from nmf_tpu_torch.ops.sparse_format import build_tiled
from nmf_tpu_torch.ops.sparse_shard import shard_tiled

from torch_parity import coo_of, three_class_matrix

CLOSE = dict(rtol=1e-9, atol=1e-12)
JAX_CLOSE = dict(rtol=1e-8, atol=1e-10)
ALGS = ["cd", "greedycd", "multmse", "multdiv", "projals", "alspgrad"]
LANE_LOOP = ("multmse", "multdiv", "projals", "alspgrad")


def _dense(seed=0, p=36, n=28):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((p, 3)) @ rng.random((3, n))
                            + 0.1 * rng.random((p, n)))


def _store():
    Xd = three_class_matrix(seed=4, p=260, n=140).astype(np.float64)
    r, c, v = coo_of(Xd)
    return build_tiled(r, c, v, Xd.shape, device="cpu", stripe_tiles=2,
                       dense_tile_nnz=1000, coo_tail_nnz=40)


def _assert_same(a, b, exact):
    assert (a.niters, a.converged) == (b.niters, b.converged)
    if exact:
        assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
        assert a.objvalue == b.objvalue
    else:
        np.testing.assert_allclose(a.W.numpy(), b.W.numpy(), **CLOSE)
        np.testing.assert_allclose(a.H.numpy(), b.H.numpy(), **CLOSE)
        assert np.isclose(a.objvalue, b.objvalue, **CLOSE)


@pytest.mark.parametrize("kind", ["dense", "store"])
@pytest.mark.parametrize("alg", ALGS)
def test_parallel_equals_sequential(alg, kind):
    X = _dense() if kind == "dense" else _store()
    kw = dict(alg=alg, init="random", device="cpu", seed=5,
              **(dict(replicates=3, maxiter=3) if alg == "alspgrad"
                 else dict(replicates=4, maxiter=12)))
    seq = nt.nnmf(X, 3, **kw)
    par = nt.nnmf(X, 3, parallel_replicates=True, **kw)
    _assert_same(par, seq, exact=alg in LANE_LOOP or kind == "store")


def test_batched_lanes_never_take_the_sequential_loop(monkeypatch):
    """A solver with a batched updater runs its restarts in solve_lanes:
    ``solve`` is called once (the first solve) and never for a restart."""
    calls = []
    solve = interface.solve
    monkeypatch.setattr(interface, "solve", lambda *a, **kw: (calls.append(1),
                                                               solve(*a, **kw))[1])
    for alg in ("cd", "greedycd", "multdiv"):
        calls.clear()
        nt.nnmf(_dense(), 3, alg=alg, init="random", replicates=3, maxiter=5,
                device="cpu", parallel_replicates=True)
        assert len(calls) == 1, alg


def test_spa_takes_the_sequential_loop():
    X = _dense(seed=2)
    assert reps.solve_replicates_batched(nt.SPA(), X, 3, 2, initH=True,
                                         generator=torch.Generator(),
                                         device="cpu") is None
    kw = dict(alg="spa", init="spa", replicates=3, device="cpu")
    assert nt.nnmf(X, 3, parallel_replicates=True, **kw) == nt.nnmf(X, 3, **kw)


@pytest.mark.parametrize("shift", [0.0, -1.0])
def test_the_first_solve_is_replaced_only_by_a_strictly_lower_objective(
        monkeypatch, shift):
    X = _dense(seed=3)
    W0, H0 = nt.randinit(X, 3, normalize=True, device="cpu")
    first = nt.solve(nt.MultUpdate(maxiter=5), X, W0, H0, device="cpu")
    other = nt.Result(W0, H0, 0, False, first.objvalue + shift)
    monkeypatch.setattr(interface, "solve_replicates_batched", lambda *a, **kw: other)
    got = nt.solve_replicates(nt.MultUpdate(maxiter=5), X, W0, H0, replicates=2,
                              initH=True, device="cpu", parallel=True)
    assert got == (other if shift < 0 else first)


@pytest.mark.parametrize("alg", ["cd", "greedycd", "multmse"])
def test_lanes_stop_at_their_own_iteration(alg):
    """One lane starts at a fixed point of the solver (the end of a long
    solve) and stops after one iteration; the others run on (GreedyCD's
    two stop at 40 and 47 of 50).  Each lane reports what its own solve
    does, and the early lane's factors are those its solve stops with."""
    X = _dense(seed=4)
    inst = {"cd": nt.CoordinateDescent, "greedycd": nt.GreedyCD,
            "multmse": nt.MultUpdate}[alg]
    starts = [nt.randinit(X, 3, normalize=True, device="cpu",
                          generator=torch.Generator().manual_seed(s)) for s in (1, 2)]
    fixed = nt.solve(inst(maxiter=2000, tol=1e-12), X, *starts[0], device="cpu")
    starts.insert(1, (fixed.W.contiguous(), fixed.H.contiguous()))
    Ws = torch.stack([w for w, _ in starts])
    Hs = torch.stack([h for _, h in starts])
    inst = inst(maxiter=50, tol=1e-3)
    lanes = reps.solve_lanes(inst, X, Ws, Hs, device="cpu")
    want = [nt.solve(inst, X, w, h, device="cpu") for w, h in starts]
    assert want[1].niters == 1 and want[1].converged
    assert min(want[0].niters, want[2].niters) > 30
    for lane, res in zip(lanes, want):
        _assert_same(nt.Result(*lane), res, exact=alg == "multmse")


@pytest.fixture
def cascade():
    """Sets GreedyCD's cascade knobs for one test and puts the old ones back."""
    old = dict(nt.config.greedycd_cascade)
    yield nt.config.set_greedycd_cascade
    nt.config.greedycd_cascade.update(old)


@pytest.mark.parametrize("knobs", [
    dict(),
    dict(off_rows=1, min=4, shrink=2),  # rows of all lanes gathered, levels
    dict(slab_rows=50, off_rows=1, min=8),  # slabs of 17 rows of each lane
    dict(slab_rows=100),
])
def test_greedycd_lanes_keep_their_bits_in_any_buffer(cascade, knobs):
    """The stacked buffer, its compaction cascade and its row slabs leave
    each lane's rows the bits of its own solve (here the wide product keeps
    each column's bits too)."""
    X = _dense(seed=8, p=60, n=45)
    starts = [nt.randinit(X, 4, normalize=True, device="cpu",
                          generator=torch.Generator().manual_seed(s)) for s in range(3)]
    inst = nt.GreedyCD(maxiter=6)
    want = [nt.solve(inst, X, w, h, device="cpu") for w, h in starts]
    cascade(**knobs)
    lanes = reps.solve_lanes(inst, X, torch.stack([w for w, _ in starts]),
                             torch.stack([h for _, h in starts]), device="cpu")
    for lane, res in zip(lanes, want):
        _assert_same(nt.Result(*lane), res, exact=True)


def test_shuffled_hals_lanes_visit_the_sequential_permutations():
    X = _dense(seed=6)
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    kw = dict(alg="cd", init="random", replicates=3, maxiter=10, device="cpu",
              seed=1)
    inst = nt.CoordinateDescent(maxiter=10, shuffle=True, generator=gen)
    seq = interface.solve_replicates(inst, X, *nt.randinit(X, 3, device="cpu"),
                                     replicates=3, initH=True, device="cpu")
    par = interface.solve_replicates(inst, X, *nt.randinit(X, 3, device="cpu"),
                                     replicates=3, initH=True, device="cpu",
                                     parallel=True)
    _assert_same(par, seq, exact=False)
    assert torch.equal(gen.get_state(), state)  # the options' stream is untouched
    # a shuffled solve is not the unshuffled one
    plain = nt.nnmf(X, 3, **kw)
    assert not torch.equal(plain.W, par.W)


def test_on_a_sharded_store_mesh():
    Xd = three_class_matrix(seed=4, p=260, n=140)
    r, c, v = coo_of(Xd)
    mesh = nt.make_mesh((2, 4), devices=["cpu"] * 8)
    X = shard_tiled(r, c, v, Xd.shape, mesh, stripe_tiles=1)
    kw = dict(alg="cd", init="random", replicates=3, maxiter=8, device="cpu",
              mesh=mesh)
    seq = nt.nnmf(X, 3, **kw)
    par = nt.nnmf(X, 3, parallel_replicates=True, **kw)
    _assert_same(par, seq, exact=True)


# ---------------------------------------------------------------------------
# each lane against the JAX package's vmapped solve


def _jax_inst(alg):
    return {"cd": nmf_tpu.CoordinateDescent(maxiter=10),
            "greedycd": nmf_tpu.GreedyCD(maxiter=10),
            "multmse": nmf_tpu.MultUpdate(obj="mse", maxiter=10),
            "projals": nmf_tpu.ProjectedALS(maxiter=10),
            "alspgrad": nmf_tpu.ALSPGrad(maxiter=3)}[alg]


def _port_inst(alg):
    return {"cd": nt.CoordinateDescent(maxiter=10),
            "greedycd": nt.GreedyCD(maxiter=10),
            "multmse": nt.MultUpdate(obj="mse", maxiter=10),
            "projals": nt.ProjectedALS(maxiter=10),
            "alspgrad": nt.ALSPGrad(maxiter=3)}[alg]


@pytest.mark.parametrize("alg", ["cd", "greedycd", "multmse", "projals", "alspgrad"])
def test_lanes_against_the_jax_vmapped_solve(alg):
    rng = np.random.default_rng(12)
    X = rng.random((30, 3)) @ rng.random((3, 24)) + 0.05 * rng.random((30, 24))
    Ws, Hs = rng.random((3, 30, 3)), rng.random((3, 3, 24))
    upd, tol = _jax_inst(alg)._resolved(jnp.float64)
    batched = jax.vmap(_solve_while, in_axes=(None, None, 0, 0, None, None))
    Wj, Hj, tj, cj, oj = batched(upd, jnp.asarray(X), jnp.asarray(Ws),
                                 jnp.asarray(Hs), upd.maxiter, jnp.asarray(tol))
    lanes = reps.solve_lanes(_port_inst(alg), torch.from_numpy(X),
                             torch.from_numpy(Ws), torch.from_numpy(Hs), device="cpu")
    for i, (W, H, t, conv, objv) in enumerate(lanes):
        assert t == int(tj[i]) and conv == bool(cj[i])
        np.testing.assert_allclose(W.numpy(), np.asarray(Wj[i]), **JAX_CLOSE)
        np.testing.assert_allclose(H.numpy(), np.asarray(Hj[i]), **JAX_CLOSE)
        assert np.isclose(float(objv), float(oj[i]), **JAX_CLOSE)
