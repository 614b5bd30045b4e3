"""One process a card, on the CPU: the three flows of
``tests/test_multihost.py`` (a distributed dense solve, a process-local
store build, a checkpoint resumed after a crash between two processes'
saves) run as two gloo processes (``tests/torch_distributed_flows.py``),
each owning four ``"cpu"`` cells of a (2, 4) mesh, at the reference's own
shapes.  Each flow is held three ways:

* the two processes against each other: the same bits (``np.array_equal``),
  since every process adds every block's partial in one fixed order;
* against the port's one-process (2, 4) mesh in this process: the same bits
  (the blocks are built alike and their partials added in the same order;
  the nnz-vector sums are block sums added in block order on both), with
  the workers' number of torch threads (``flows.THREADS``): torch's CPU
  products may sum in another order with another count;
* against the JAX package's solve of the same inputs in this process (not
  under ``jax.distributed``), whole and unsharded: float32 sums taken in
  another order, over 3-20 iterations; factors ``rtol=2e-4, atol=2e-5`` and
  objective ``rtol=1e-4`` (``tests/test_torch_sharded.py``'s factors, its
  objective tightened); the product against float64 at ``rtol=3e-5,
  atol=1e-4``, ``tests/test_multihost.py``'s.

Every worker runs under ``communicate(timeout=...)`` and a process-group
timeout of 60 s, so a hang fails the test.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nmf_tpu
import nmf_tpu_torch as nt
import torch_distributed_flows as flows

ROOT = pathlib.Path(__file__).resolve().parents[1]
FACTORS = dict(rtol=2e-4, atol=2e-5)
OBJECTIVE = dict(rtol=1e-4)
PRODUCT = dict(rtol=3e-5, atol=1e-4)
FLOWS = ("dense_solve", "local_store", "checkpoint_resume")
RESULT = ("W", "H", "niters", "objvalue")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both processes' results, read from their files."""
    out = tmp_path_factory.mktemp("ranks")
    ckdir = out / "ck"
    ckdir.mkdir()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_distributed_flows.py"), str(r),
         str(port), str(out), str(ckdir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]
    return got, sorted(os.listdir(ckdir))


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The same flows on a one-process (2, 4) mesh of CPU cells."""
    mesh = nt.make_mesh(flows.SHAPE, devices=["cpu"] * 8)
    ckdir = tmp_path_factory.mktemp("ck_one")
    threads = torch.get_num_threads()
    torch.set_num_threads(flows.THREADS)  # the workers' count
    try:
        return {"dense_solve": flows.dense_solve(mesh),
                "local_store": flows.local_store(mesh),
                "checkpoint_resume": flows.checkpoint_resume(mesh, str(ckdir))}
    finally:
        torch.set_num_threads(threads)


def _flow(rank, name):
    assert f"{name}/error" not in rank, str(rank[f"{name}/error"])
    return {k.split("/", 1)[1]: v for k, v in rank.items() if k.startswith(name + "/")}


def _jax_solve(alg, X, W, H):
    res = nmf_tpu.solve(alg, jnp.asarray(X), jnp.asarray(W), jnp.asarray(H))
    return np.asarray(res.W), np.asarray(res.H), int(res.niters), float(res.objvalue)


def _jax_reference(name):
    if name == "dense_solve":
        return _jax_solve(nmf_tpu.MultUpdate(obj="mse", maxiter=10, tol=1e-30),
                          *flows.dense_problem(64, 64, 4))
    if name == "local_store":
        Xd, _, W0, H0 = flows.sparse_problem()
        return _jax_solve(nmf_tpu.MultUpdate(obj="div", maxiter=3), Xd, W0, H0)
    return _jax_solve(nmf_tpu.MultUpdate(obj="mse", maxiter=20, tol=1e-12),
                      *flows.dense_problem(64, 48, 4))


@pytest.mark.parametrize("name", FLOWS)
def test_the_two_processes_give_each_other_bits(ranks, name):
    a, b = (_flow(r, name) for r in ranks[0])
    assert a.keys() == b.keys()
    for key in a:
        if key not in ("nnz_local", "slot_share"):
            assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("name", FLOWS)
def test_the_processes_give_the_one_process_mesh_bits(ranks, one_process, name):
    got = _flow(ranks[0][1], name)
    want = one_process[name]
    for key in want:
        if key not in ("nnz_local", "slot_share", "agreed", "first_latest",
                       "last_latest"):
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", FLOWS)
def test_the_processes_match_the_jax_package(ranks, name):
    got = _flow(ranks[0][0], name)
    W, H, niters, objvalue = _jax_reference(name)
    assert int(got["niters"]) == niters
    np.testing.assert_allclose(got["W"], W, **FACTORS)
    np.testing.assert_allclose(got["H"], H, **FACTORS)
    np.testing.assert_allclose(float(got["objvalue"]), objvalue, **OBJECTIVE)


def test_local_store_shares_and_partitions(ranks):
    """Each process holds at most 0.75 of the slots, the two sets of
    entries partition X, every process sees the whole load table, and the
    product is X's."""
    Xd, D, *_ = flows.sparse_problem()
    a, b = (_flow(r, "local_store") for r in ranks[0])
    for f in (a, b):
        assert f["slot_share"] <= 0.75
        assert 0 < f["nnz_local"] < f["nnz_total"]
        assert f["total_nnz"].sum() == f["nnz_total"] == np.count_nonzero(Xd)
        np.testing.assert_allclose(f["mm"], Xd.astype(np.float64) @ D, **PRODUCT)
    assert a["nnz_local"] + b["nnz_local"] == a["nnz_total"]
    assert a["slot_share"] + b["slot_share"] == pytest.approx(1.0)


def test_checkpoint_resumes_from_the_agreed_step(ranks):
    """Process 0 lost its step-10 file: both agree on 5, resume to 20 and
    give the uninterrupted solve; each process wrote only its own files."""
    got, names = ranks
    for r in (0, 1):
        f = _flow(got[r], "checkpoint_resume")
        assert (f["first_latest"], f["agreed"], f["last_latest"]) == (10, 5, 20)
        assert f["niters"] == 20
        for key in RESULT:
            assert np.array_equal(f[key], f["plain_" + key]), key
    assert any(".proc0.npz" in n for n in names)
    assert any(".proc1.npz" in n for n in names)


@pytest.mark.parametrize("case", ["foreign_entry", "uneven_grid"])
def test_errors_raise_on_every_process(ranks, case):
    match = {"foreign_entry": "owned by other processes",
             "uneven_grid": "does not split evenly among 2 processes"}[case]
    for r in ranks[0]:
        assert match in str(_flow(r, "errors")[case])


def test_a_second_init_distributed_is_a_no_op(ranks):
    for r in ranks[0]:
        assert bool(r["second_init_kept_the_group"])

