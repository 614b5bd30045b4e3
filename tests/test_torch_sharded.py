"""The sharded sparse path of the PyTorch build (``parallel/mesh.py``,
``parallel/sharding.py``, ``ops/sparse_shard.py``) on the CPU, against the
JAX package's sharded store on its (2, 4) mesh of virtual devices, against
float64 products, and against the port's own single store.

Meshes: ``make_mesh((2, 4), devices=["cpu"] * 8)``, the JAX tests' grid,
and (1, 1).  Every block runs the kernels' plain versions here.

Tolerances:

* products against float64 and against the JAX package's sharded products
  (float32 sums of at most a few hundred terms, taken in another order):
  ``rtol=3e-5, atol=1e-4``, those of ``tests/test_sparse_sharded.py``;
* a (1, 1) mesh against the single store built with the same options:
  ``torch.equal``.  The one block is the store, its rows and columns
  padded to whole tiles, and those padding rows hold no entry, so every
  sum is taken over the same terms in the same order;
* solvers against the JAX package's dense ``nnmf`` from the same factors:
  factors ``rtol=atol=2e-4`` and objective ``rtol=1e-3``; GreedyCD's
  factors ``5e-2`` (its argmax schedule follows the products' last bits),
  as in ``tests/test_sparse_sharded.py``;
* ``solve_checkpointed`` against ``solve`` and the store rebuilt through
  ``nnmf`` against a prebuilt ``ShardedTiled``: ``torch.equal``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
from nmf_tpu.ops import sparse_shard as jshard
from nmf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops import sparse_shard as shard
from nmf_tpu_torch.ops.sparse_format import build_tiled
from nmf_tpu_torch.parallel.mesh import COLS, ROWS, auto_mesh_shape, make_mesh

from torch_parity import coo_of, three_class_matrix

PRODUCT = dict(rtol=3e-5, atol=1e-4)
P, N = 600, 500

OPTS = {
    "natural": dict(stripe_tiles=2, order="natural"),
    "degree": dict(stripe_tiles=2),
    "hybrid": dict(stripe_tiles=2, dense_tile_nnz=100, quad_tail_nnz=16,
                   coo_tail_nnz=2),
}
MESHES = {"2x4": (2, 4), "1x1": (1, 1)}


def four_region_matrix(seed=0, p=P, n=N):
    """Float32 matrix whose tiles on the (2, 4) mesh fall into all four
    store classes of ``OPTS["hybrid"]``: a dense head (~30 % full), a body
    of plain chunks (~0.3 %) and a dust of ~5 entries a tile (quad tiles,
    and band tiles of at most 2)."""
    rng = np.random.default_rng(seed)
    dens = np.full((p, n), 0.0003)
    dens[128:384, :256] = 0.003
    dens[:128, :128] = 0.3
    return ((rng.random((p, n)) + 0.5) * (rng.random((p, n)) < dens)).astype(np.float32)


def cpu_mesh(shape):
    return make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def sharded(Xd, shape, opts):
    r, c, v = coo_of(Xd)
    return shard.shard_tiled(r, c, v, Xd.shape, cpu_mesh(shape), **opts)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(1)
    Xd = four_region_matrix()
    return (Xd, rng.random((N, 12), dtype=np.float32),
            rng.random((P, 12), dtype=np.float32),
            rng.random((P, 7), dtype=np.float32), rng.random((7, N), dtype=np.float32))


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_shape_lead_and_errors(monkeypatch):
    assert auto_mesh_shape(8) == (2, 4) and auto_mesh_shape(7) == (1, 7)
    mesh = cpu_mesh((2, 4))
    assert mesh.shape[ROWS] == 2 and mesh.shape[COLS] == 4
    assert mesh.lead == torch.device("cpu")
    assert mesh == cpu_mesh((2, 4)) and mesh != cpu_mesh((4, 2))
    assert make_mesh(devices=["cpu"] * 6).devices.shape == (2, 3)
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh((2, 2), devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), devices=["cuda:0"])
    # init_distributed checks its arguments before it joins a group (the
    # joins themselves: tests/test_torch_distributed.py)
    with pytest.raises(ValueError, match="together"):
        nt.parallel.mesh.init_distributed("localhost:1", None, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nt.parallel.mesh.init_distributed()


# ---------------------------------------------------------------------------
# products


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("opts", OPTS)
def test_products_against_float64(problem, opts, mesh):
    Xd, D, D2, W, H = problem
    X = sharded(Xd, MESHES[mesh], OPTS[opts])
    X64 = Xd.astype(np.float64)
    np.testing.assert_allclose(shard.sharded_mm(X, t(D)).numpy(), X64 @ D, **PRODUCT)
    np.testing.assert_allclose(shard.sharded_mtm(X, t(D2)).numpy(), X64.T @ D2,
                               **PRODUCT)
    np.testing.assert_allclose(matops.mm(matops.transpose(X), t(D2)).numpy(),
                               X64.T @ D2, **PRODUCT)
    np.testing.assert_allclose(matops.mtm(t(D2).T, X).numpy(), D2.T @ X64, **PRODUCT)
    rows = matops.row_indices(X).numpy()
    cols = matops.col_indices(X).numpy()
    assert len(rows) == np.count_nonzero(Xd) == X.nnz
    np.testing.assert_array_equal(matops.nnz_values(X).numpy(), Xd[rows, cols])
    np.testing.assert_allclose(matops.sddmm(t(W), t(H), X).numpy(),
                               (W.astype(np.float64) @ H)[rows, cols], **PRODUCT)
    for got in (matops.colsums(X), shard.sharded_colsums(X)):
        np.testing.assert_allclose(got.numpy(), X64.sum(0), **PRODUCT)
    for got in (matops.rowsums(X), shard.sharded_rowsums(X)):
        np.testing.assert_allclose(got.numpy(), X64.sum(1), **PRODUCT)
    assert bool(matops.all_nonneg(X))
    assert np.isclose(float(matops.sq_norm(X)), (X64 ** 2).sum(), rtol=1e-6)


def test_products_against_the_jax_package(problem):
    """One option set (degree order, the default) on both packages' (2, 4)
    mesh: the JAX package's sharded products are jitted there."""
    Xd, D, D2, _, _ = problem
    r, c, v = coo_of(Xd)
    Xj = jshard.shard_tiled(r, c, v, Xd.shape, jax_make_mesh((2, 4)), stripe_tiles=2)
    X = sharded(Xd, (2, 4), OPTS["degree"])
    np.testing.assert_allclose(shard.sharded_mm(X, t(D)).numpy(),
                               np.asarray(jshard.sharded_mm(Xj, jnp.asarray(D))),
                               **PRODUCT)
    np.testing.assert_allclose(shard.sharded_mtm(X, t(D2)).numpy(),
                               np.asarray(jshard.sharded_mtm(Xj, jnp.asarray(D2))),
                               **PRODUCT)


@pytest.mark.parametrize("opts", OPTS)
def test_block_layout_against_the_jax_package(opts):
    """The per-block permutations, the entries a block and the load report
    equal the JAX package's on a matrix with no stored zeros."""
    Xd = four_region_matrix(seed=2)
    r, c, v = coo_of(Xd)
    Xj = jshard.shard_tiled(r, c, v, Xd.shape, jax_make_mesh((2, 4)), **OPTS[opts])
    X = sharded(Xd, (2, 4), OPTS[opts])
    for name in ("row_perm", "row_rank", "col_perm", "col_rank"):
        want = getattr(Xj, name)
        if want is None:
            assert getattr(X, name) is None
        else:
            np.testing.assert_array_equal(getattr(X, name).numpy(), np.asarray(want))
    assert X.block_nnz == Xj.block_nnz
    got, want = shard.sharded_load_stats(X), jshard.sharded_load_stats(Xj)
    for key in ("chunk_nnz", "dense_nnz", "quad_nnz", "coo_nnz", "total_nnz",
                "pattern_nnz"):
        assert (key in got) == (key in want), key
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert got["imbalance_max_over_mean"] == want["imbalance_max_over_mean"]
    assert (got["slots"] >= got["total_nnz"]).all()


@pytest.mark.parametrize("opts", OPTS)
def test_one_by_one_mesh_gives_the_store_bits(problem, opts):
    Xd, D, D2, W, H = problem
    r, c, v = coo_of(Xd)
    X = sharded(Xd, (1, 1), OPTS[opts])
    store = build_tiled(r, c, v, Xd.shape, device="cpu", **OPTS[opts])
    for fn, arg in ((matops.mm, t(D)), (lambda A, d: matops.mtm(d.T, A), t(D2))):
        assert torch.equal(fn(X, arg), fn(store, arg))
    assert torch.equal(matops.sddmm(t(W), t(H), X), matops.sddmm(t(W), t(H), store))
    assert torch.equal(matops.colsums(X), matops.colsums(store))
    assert torch.equal(matops.rowsums(X), matops.rowsums(store))
    assert torch.equal(X.stats, store.stats)


def test_transpose_is_the_other_orientation(problem):
    Xd, D, D2, W, H = problem
    X = sharded(Xd, (2, 4), OPTS["hybrid"])
    Xt = X.transpose()
    assert Xt.shape == (N, P) and Xt.transpose().blocks == X.blocks
    assert torch.equal(shard.sharded_mm(Xt, t(D2)), shard.sharded_mtm(X, t(D2)))
    # the transposed nnz vector samples (W H)' at the transposed pattern
    rows, cols = matops.row_indices(Xt).numpy(), matops.col_indices(Xt).numpy()
    np.testing.assert_array_equal(matops.nnz_values(Xt).numpy(), Xd.T[rows, cols])
    np.testing.assert_allclose(matops.sddmm(t(H).T, t(W).T, Xt).numpy(),
                               (W.astype(np.float64) @ H).T[rows, cols], **PRODUCT)


def test_scale_values_updates_both_orientations(problem):
    Xd, D, D2, _, _ = problem
    X = sharded(Xd, (2, 4), OPTS["hybrid"])
    rows, cols = matops.row_indices(X).numpy(), matops.col_indices(X).numpy()
    new = matops.nnz_values(X) * (1 + torch.arange(X.nnz) % 5)
    Xs = matops.scale_values(X, new)
    Yd = np.zeros_like(Xd, dtype=np.float64)
    Yd[rows, cols] = new.numpy()
    np.testing.assert_allclose(matops.mm(Xs, t(D)).numpy(), Yd @ D, **PRODUCT)
    np.testing.assert_allclose(matops.mtm(t(D2).T, Xs).numpy(), D2.T @ Yd, **PRODUCT)
    assert torch.equal(matops.nnz_values(Xs), new)
    assert np.isclose(float(matops.total_sum(Xs)), Yd.sum(), rtol=1e-6)
    assert np.isclose(float(matops.sq_norm(Xs)), (Yd ** 2).sum(), rtol=1e-6)


# ---------------------------------------------------------------------------
# solvers


ALGS = ["cd", "greedycd", "multmse", "multdiv", "projals", "alspgrad"]


@pytest.fixture(scope="module")
def solve_problem():
    Xd = three_class_matrix(seed=4)
    rng = np.random.default_rng(5)
    k = 4
    return (Xd, rng.random((Xd.shape[0], k), dtype=np.float32),
            rng.random((k, Xd.shape[1]), dtype=np.float32))


@pytest.mark.parametrize("alg", ALGS)
def test_nnmf_on_a_mesh_against_the_jax_package(solve_problem, alg):
    Xd, W0, H0 = solve_problem
    k = W0.shape[1]
    kw = dict(alg=alg, init="custom", W0=W0, H0=H0, maxiter=8)
    mesh = cpu_mesh((2, 4))
    got = nt.nnmf(sharded(Xd, (2, 4), dict(stripe_tiles=1)), k, mesh=mesh,
                  device="cpu", **kw)
    want = nmf_tpu.nnmf(jnp.asarray(Xd), k, **kw)
    assert got.niters == want.niters
    tol = dict(rtol=5e-2, atol=5e-2) if alg == "greedycd" else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.W.numpy(), np.asarray(want.W), **tol)
    np.testing.assert_allclose(got.H.numpy(), np.asarray(want.H), **tol)
    assert np.isclose(got.objvalue, float(want.objvalue), rtol=1e-3)


def test_spa_on_a_mesh_against_the_dense_port():
    rng = np.random.default_rng(6)
    Xd = (rng.random((300, 260)) * (rng.random((300, 260)) < 0.07)).astype(np.float32)
    X = sharded(Xd, (2, 4), OPTS["degree"])
    Ws, Hs = nt.spa(X, 4, device="cpu")
    Wd, Hd = nt.spa(t(Xd), 4, device="cpu")
    assert torch.equal(Ws, Wd)  # the anchors' columns, copied from the values
    np.testing.assert_allclose(Hs.numpy(), Hd.numpy(), rtol=2e-3, atol=2e-3)
    res = nt.nnmf(X, 4, init="spa", alg="spa", mesh=cpu_mesh((2, 4)), device="cpu")
    assert np.isfinite(res.objvalue)


def test_front_door_rebuilds_a_store_or_a_torch_sparse_x(solve_problem):
    """nnmf(TiledCSR, mesh=...) and nnmf(torch sparse, mesh=...) rebuild X as
    the ShardedTiled shard_tiled builds with the same options, and give its
    bits, a restart included.  (The init runs on X as given, before the
    rebuild, so the comparison takes a random start, which reads only X's
    shape.)"""
    Xd, _, _ = solve_problem
    r, c, v = coo_of(Xd)
    mesh = cpu_mesh((2, 4))
    opts = dict(stripe_tiles=1, dense_tile_nnz=1000, coo_tail_nnz=40)
    kw = dict(init="random", maxiter=4, replicates=2, device="cpu", mesh=mesh)
    want = nt.nnmf(shard.shard_tiled(r, c, v, Xd.shape, mesh, **opts), 3, **kw)
    got = nt.nnmf(build_tiled(r, c, v, Xd.shape, device="cpu", **opts), 3, **kw)
    assert torch.equal(got.W, want.W) and torch.equal(got.H, want.H)
    plain = nt.nnmf(shard.shard_tiled(r, c, v, Xd.shape, mesh), 3, **kw)
    got = nt.nnmf(t(Xd).to_sparse_coo(), 3, **kw)
    assert torch.equal(got.W, plain.W) and got.objvalue == plain.objvalue
    # with every default: the NNDSVD-ar start on the torch sparse X, then the
    # solve on the mesh
    res = nt.nnmf(t(Xd).to_sparse_coo(), 3, maxiter=4, device="cpu", mesh=mesh)
    assert np.isfinite(res.objvalue) and res.W.shape == (Xd.shape[0], 3)


def test_errors():
    Xd = three_class_matrix(seed=7)
    mesh = cpu_mesh((2, 4))
    X = sharded(Xd, (2, 4), OPTS["degree"])
    with pytest.raises(ValueError, match="different mesh"):
        nt.nnmf(X, 3, mesh=cpu_mesh((1, 1)), device="cpu")
    # a dense X on a mesh is cut into dense blocks (tests/test_torch_sharded_dense.py)
    assert nt.nnmf(t(Xd), 3, mesh=mesh, device="cpu", maxiter=2).niters == 2
    # local=True in one process: every entry is its own, the local=False store
    loc = shard.shard_tiled(*coo_of(Xd), Xd.shape, mesh, local=True, **OPTS["degree"])
    D = torch.rand((Xd.shape[1], 3), generator=torch.Generator().manual_seed(0))
    assert loc.block_nnz == X.block_nnz and torch.equal(loc.stats, X.stats)
    assert torch.equal(shard.sharded_mm(loc, D), shard.sharded_mm(X, D))
    meta = make_mesh((1, 1), devices=["meta"])
    with pytest.raises(ValueError, match="lead device"):
        nt.nnmf(X, 3, mesh=meta, device="cpu")
    r, c, v = coo_of(Xd)
    with pytest.raises(ValueError, match="slim"):
        nt.parallel.sharding.shard_problem(
            mesh, build_tiled(r, c, v, Xd.shape, device="cpu").slim(),
            torch.zeros(1), torch.zeros(1))


@pytest.mark.parametrize("alg", ["cd", "greedycd", "multdiv"])
def test_checkpointed_gives_the_solve_bits(solve_problem, alg, tmp_path):
    Xd, W0, H0 = solve_problem
    X = sharded(Xd, (2, 4), OPTS["hybrid"])
    inst = {"cd": nt.CoordinateDescent(maxiter=9),
            "greedycd": nt.GreedyCD(maxiter=6),
            "multdiv": nt.MultUpdate(obj="div", maxiter=6)}[alg]
    a = nt.solve(inst, X, t(W0), t(H0), device="cpu")
    b = nt.solve_checkpointed(inst, X, t(W0), t(H0), checkpoint_dir=str(tmp_path),
                              checkpoint_every=4, device="cpu")
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert a.niters == b.niters and a.objvalue == b.objvalue
