"""Checkpoint / resume of the PyTorch build against its own uninterrupted
solve (bit for bit) and against the JAX package's ``solve_checkpointed``
(float64, ``rtol=1e-12``).

The JAX package draws Fast-HALS's shuffled order from a JAX random key and
the port from a ``torch.Generator``: the two orders differ, so shuffled HALS
is held to the port's own solve only, and unshuffled HALS stands in for it
against the JAX package."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu as J
from nmf_tpu.models import checkpoint as jck
import nmf_tpu_torch as nt
from nmf_tpu_torch.models import checkpoint as tck
from nmf_tpu_torch.models import common as tcommon
from nmf_tpu_torch.ops.sparse_format import build_tiled

from testproblems import laurberg6x3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the two packages sum their products in other orders: 1e-12 relative, and
# 1e-15 absolute (a few ulps of the factors' largest entries, about 1) for
# entries near 0, where one rounding residue is a large relative difference
F64 = dict(rtol=1e-12, atol=1e-15)

# options of one solver, built from either package's module
SOLVERS = {
    "mu_mse": lambda M: M.MultUpdate(obj="mse", maxiter=37, tol=1e-9),
    "alspgrad": lambda M: M.ALSPGrad(maxiter=17, tol=1e-9),
    "cd": lambda M: M.CoordinateDescent(maxiter=23, tol=1e-9),
    "cd_shuffled": lambda M: M.CoordinateDescent(maxiter=23, tol=1e-9, shuffle=True),
    "greedycd": lambda M: M.GreedyCD(maxiter=19, tol=1e-9),
    "projals": lambda M: M.ProjectedALS(maxiter=15, tol=1e-9),
}


def make_problem(seed=5):
    """The JAX package's checkpoint problem: laurberg6x3 in float64."""
    rng = np.random.default_rng(seed)
    X, Wg, Hg = laurberg6x3(0.3)
    W = Wg + rng.random(Wg.shape) * 0.1
    H = rng.random(Hg.shape)
    return X, W, H


def torch_problem(seed=5):
    return tuple(torch.from_numpy(a) for a in make_problem(seed))


def same(a, b):
    """Two Results with the same bits (``Result.__eq__`` compares W, H,
    niters, converged and objvalue exactly)."""
    assert a.niters == b.niters and a.converged == b.converged
    assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
    assert a.objvalue == b.objvalue
    assert a == b


def close_to_jax(rt, rj):
    assert rt.niters == rj.niters and rt.converged == rj.converged
    np.testing.assert_allclose(rt.W.numpy(), np.asarray(rj.W), **F64)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), **F64)
    np.testing.assert_allclose(rt.objvalue, rj.objvalue, **F64)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_checkpointed_equals_plain_and_jax(tmp_path, name):
    X, W, H = torch_problem()
    alg = SOLVERS[name](nt)
    plain = nt.solve(alg, X, W, H, device="cpu")
    ck = nt.solve_checkpointed(alg, X, W, H, checkpoint_dir=str(tmp_path / "t"),
                               checkpoint_every=7, device="cpu")
    same(ck, plain)
    if name == "cd_shuffled":
        return
    Xj, Wj, Hj = (jnp.asarray(a) for a in make_problem())
    rj = jck.solve_checkpointed(SOLVERS[name](J), Xj, Wj, Hj,
                                checkpoint_dir=str(tmp_path / "j"), checkpoint_every=7)
    close_to_jax(ck, rj)


def small_store(seed=3, p=70, n=55):
    """A small degree-ordered store (the default order), whose solves run in
    renumbered coordinates."""
    rng = np.random.default_rng(seed)
    Xd = (rng.random((p, n)) + 0.5) * (rng.random((p, n)) < 0.25)
    r, c = np.nonzero(Xd)
    Xt = build_tiled(r, c, Xd[r, c], Xd.shape, device="cpu", dense_tile_nnz=900,
                     coo_tail_nnz=2)
    W = torch.from_numpy(rng.random((p, 4)).astype(np.float32))
    H = torch.from_numpy(rng.random((4, n)).astype(np.float32))
    return Xt, W, H


STORE_SOLVERS = {
    "mu_mse": lambda: nt.MultUpdate(obj="mse", maxiter=9, tol=1e-9),
    "mu_div": lambda: nt.MultUpdate(obj="div", maxiter=9, tol=1e-9),
    "alspgrad": lambda: nt.ALSPGrad(maxiter=6, tol=1e-9),
    "cd_shuffled": lambda: nt.CoordinateDescent(
        maxiter=9, tol=1e-9, shuffle=True, generator=torch.Generator().manual_seed(4)),
    "greedycd": lambda: nt.GreedyCD(maxiter=9, tol=1e-9),
    "projals": lambda: nt.ProjectedALS(maxiter=9, tol=1e-9),
}


@pytest.mark.parametrize("name", sorted(STORE_SOLVERS))
def test_checkpointed_on_a_renumbered_store_equals_plain(tmp_path, name):
    Xt, W, H = small_store()
    alg = STORE_SOLVERS[name]()
    assert tcommon._renumber_ok(alg._resolved(torch.float32)[0], Xt)
    plain = nt.solve(alg, Xt, W, H, device="cpu")
    d = str(tmp_path / "ck")
    ck = nt.solve_checkpointed(alg, Xt, W, H, checkpoint_dir=d, checkpoint_every=4,
                               device="cpu")
    same(ck, plain)
    # the snapshot holds the factors in the caller's coordinates
    path, step = tck.latest_checkpoint(d)
    assert step == ck.niters
    state = tcommon._prepare(alg._resolved(torch.float32)[0], Xt, W, H)
    Ws, Hs, _, t = tck.load_state(path, (W, H, state, torch.zeros((), dtype=torch.int32)))
    assert int(t) == step and torch.equal(Ws, ck.W) and torch.equal(Hs, ck.H)


@pytest.mark.parametrize("name", ["mu_mse", "cd_shuffled"])
def test_resume_after_interruption(tmp_path, name):
    X, W, H = torch_problem()
    long = {"mu_mse": lambda n: nt.MultUpdate(obj="mse", maxiter=n, tol=1e-12),
            "cd_shuffled": lambda n: nt.CoordinateDescent(
                maxiter=n, tol=1e-12, shuffle=True,
                generator=torch.Generator().manual_seed(11))}[name]
    plain = nt.solve(long(40), X, W, H, device="cpu")
    d = str(tmp_path / "ck")
    # run the first 2 chunks only, "crash", then resume with the whole budget
    nt.solve_checkpointed(long(20), X, W, H, checkpoint_dir=d, checkpoint_every=10,
                          device="cpu")
    assert tck.latest_checkpoint(d)[1] == 20
    resumed = nt.solve_checkpointed(long(40), X, W, H, checkpoint_dir=d,
                                    checkpoint_every=10, device="cpu")
    same(resumed, plain)
    if name == "mu_mse":
        Xj, Wj, Hj = (jnp.asarray(a) for a in make_problem())
        close_to_jax(resumed, J.solve(J.MultUpdate(obj="mse", maxiter=40, tol=1e-12),
                                      Xj, Wj, Hj))


def test_step_agreement_logic(tmp_path):
    """The largest step present on EVERY process; with one process
    ``agreed_checkpoint`` is ``latest_checkpoint``."""
    assert tck._common_latest([[5, 10], [5]]) == 5
    assert tck._common_latest([[5, 10, 15], [10, 15], [5, 15]]) == 15
    assert tck._common_latest([[10], [5]]) is None
    assert tck._common_latest([]) is None
    X, W, H = torch_problem()
    d = str(tmp_path / "ck")
    nt.solve_checkpointed(nt.MultUpdate(obj="mse", maxiter=10, tol=1e-12), X, W, H,
                          checkpoint_dir=d, checkpoint_every=5, device="cpu")
    assert tck.agreed_checkpoint(d) == tck.latest_checkpoint(d)
    assert tck.latest_checkpoint(d) == (os.path.join(d, "ckpt_10.proc0.npz"), 10)
    assert tck.agreed_checkpoint(str(tmp_path / "none")) is None


def test_keep_and_prune_above(tmp_path):
    X, W, H = torch_problem()
    d = str(tmp_path / "ck")
    alg = nt.MultUpdate(obj="mse", maxiter=12, tol=1e-12)
    nt.solve_checkpointed(alg, X, W, H, checkpoint_dir=d, checkpoint_every=2, keep=2,
                          device="cpu")
    assert sorted(os.listdir(d)) == ["ckpt_10.proc0.npz", "ckpt_12.proc0.npz"]
    # no temporary file is left behind, and the later step goes on a resume
    tck._prune_above(d, 10)
    assert os.listdir(d) == ["ckpt_10.proc0.npz"]
    resumed = nt.solve_checkpointed(alg, X, W, H, checkpoint_dir=d, checkpoint_every=2,
                                    keep=2, device="cpu")
    same(resumed, nt.solve(alg, X, W, H, device="cpu"))


@pytest.mark.parametrize("name, partial, every", [("mu_mse", 20, 10), ("alspgrad", 8, 4)])
def test_resumes_from_a_jax_checkpoint_directory(tmp_path, name, partial, every):
    """The JAX package writes the first chunks, the port resumes and
    finishes: the JAX package's uninterrupted solve, to 1e-12."""
    full = {"mu_mse": lambda M, n: M.MultUpdate(obj="mse", maxiter=n, tol=1e-12),
            "alspgrad": lambda M, n: M.ALSPGrad(maxiter=n, tol=1e-12)}[name]
    Xj, Wj, Hj = (jnp.asarray(a) for a in make_problem())
    d = str(tmp_path / "ck")
    jck.solve_checkpointed(full(J, partial), Xj, Wj, Hj, checkpoint_dir=d,
                           checkpoint_every=every)
    assert tck.latest_checkpoint(d)[1] == partial
    X, W, H = torch_problem()
    rt = nt.solve_checkpointed(full(nt, 2 * partial), X, W, H, checkpoint_dir=d,
                               checkpoint_every=every, device="cpu")
    close_to_jax(rt, J.solve(full(J, 2 * partial), Xj, Wj, Hj))


def test_a_jax_hals_checkpoint_is_refused(tmp_path):
    Xj, Wj, Hj = (jnp.asarray(a) for a in make_problem())
    d = str(tmp_path / "ck")
    jck.solve_checkpointed(J.CoordinateDescent(maxiter=5, shuffle=True), Xj, Wj, Hj,
                           checkpoint_dir=d, checkpoint_every=5)
    X, W, H = torch_problem()
    with pytest.raises(ValueError, match="leaf 2 is uint32"):
        nt.solve_checkpointed(nt.CoordinateDescent(maxiter=10, shuffle=True), X, W, H,
                              checkpoint_dir=d, checkpoint_every=5, device="cpu")


def test_load_state_places_leaves_like_the_template(tmp_path):
    gen = torch.Generator().manual_seed(9)
    torch.rand(3, generator=gen)
    tree = (torch.arange(6.0).reshape(2, 3), (torch.tensor(0.25, dtype=torch.float64), gen),
            (), torch.tensor(7, dtype=torch.int32))
    path = tck.save_state(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "ckpt_7.proc0.npz"
    with np.load(path) as data:
        assert sorted(data.files) == ["l0_full", "l1_full", "l2_full", "l3_full"]
    template = (torch.zeros(2, 3, dtype=torch.float64), (torch.zeros(()), torch.Generator()),
                (), torch.zeros((), dtype=torch.int32))
    A, (tolg, g2), empty, t = tck.load_state(path, template)
    assert A.dtype == torch.float64 and torch.equal(A, tree[0].double())
    assert tolg.dtype == torch.float32 and float(tolg) == 0.25
    assert empty == () and int(t) == 7
    # the restored stream goes on where the saved one stood
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4, generator=gen))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, (torch.zeros(3, 2),) + template[1:])
    with pytest.raises(ValueError, match="missing leaf 4"):
        tck.load_state(path, template + (torch.zeros(()),))


def test_two_processes_agree_on_the_common_step(tmp_path):
    """``agreed_checkpoint`` over ``torch.distributed`` (gloo, two
    processes): each process holds other steps, and both resume from the
    largest one they share."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = textwrap.dedent(f"""
        import os, sys, numpy as np, torch, torch.distributed as dist
        from nmf_tpu_torch.models import checkpoint as tck
        rank = int(sys.argv[1])
        dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                                world_size=2, rank=rank)
        d = {str(tmp_path)!r}
        for step in ([5, 10, 15] if rank == 0 else [5, 10]):
            tck.save_state(d, step, (torch.zeros(2),))
        got = tck.agreed_checkpoint(d)
        print("AGREED", rank, os.path.basename(got[0]), got[1])
        dist.destroy_process_group()
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert f"AGREED {r} ckpt_10.proc{r}.npz 10" in out, out
