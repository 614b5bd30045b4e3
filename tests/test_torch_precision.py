"""The port's matmul precision lives in a scope around each solve
(``config.precision_scope``): inside every public entry point that computes,
cuBLAS's float32 precision reads ``"ieee"`` whatever the caller set, and the
caller's setting is back afterwards, also when the entry point raises.
Importing the package changes no torch setting.

The setting is read where the products are made: ``matops.mm`` (every
solver's and ``rsvd``'s route to X) is patched to record
``torch.backends.cuda.matmul.fp32_precision`` at each call.  On the CPU the
flag changes no result, so these tests say where it is set, not what TF32
would do (``chip_smoke.py``, phase ``precision``, holds the bits on the
card)."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch import config
from nmf_tpu_torch.models import common
from nmf_tpu_torch.models.replicates import solve_lanes
from nmf_tpu_torch.ops import matops
from nmf_tpu_torch.ops.sparse_format import build_tiled

ROOT = pathlib.Path(__file__).resolve().parents[1]
MATMUL = torch.backends.cuda.matmul


def _default_precision():
    torch.set_float32_matmul_precision("highest")
    MATMUL.fp32_precision = "none"


@pytest.fixture(autouse=True)
def default_precision():
    """Each test starts and ends at torch's defaults (``"none"`` through the
    new API, ``"highest"`` through the legacy one)."""
    _default_precision()
    yield
    _default_precision()


def _legacy_high():
    torch.set_float32_matmul_precision("high")


def _new_tf32():
    MATMUL.fp32_precision = "tf32"


CALLERS = {"legacy_high": (_legacy_high, "tf32"), "new_tf32": (_new_tf32, "tf32")}


def _caller_is_back(caller):
    assert MATMUL.fp32_precision == CALLERS[caller][1]
    if caller == "legacy_high":  # the legacy reading still answers
        assert torch.get_float32_matmul_precision() == "high"


def _problem():
    rng = np.random.default_rng(0)
    X = rng.random((14, 11)).astype(np.float32)
    r, c = np.nonzero(X)
    W = torch.from_numpy(rng.random((14, 3)).astype(np.float32))
    H = torch.from_numpy(rng.random((3, 11)).astype(np.float32))
    Xt = build_tiled(r, c, X[r, c], X.shape, device="cpu")
    return X, Xt, W, H


def _entry_points(tmp=None):
    X, Xt, W, H = _problem()
    Xd = torch.from_numpy(X)
    r, c = np.nonzero(X)
    cd = nt.CoordinateDescent(maxiter=2)
    return {
        "solve_checkpointed": lambda: nt.solve_checkpointed(
            cd, Xt, W, H, checkpoint_dir=str(tmp), checkpoint_every=1, device="cpu"),
        "nnmf_sparse_coo": lambda: nt.nnmf(Xd.to_sparse_coo(), 3, maxiter=2,
                                           device="cpu"),
        "solve": lambda: nt.solve(cd, Xt, W, H, device="cpu"),
        "solve_dense_greedycd": lambda: nt.solve(nt.GreedyCD(maxiter=2), Xd, W, H,
                                                 device="cpu"),
        "nmf_skeleton": lambda: common.nmf_skeleton(
            cd._resolved(torch.float32)[0], Xd, W.clone(), H.clone(), 2, False, 0.0),
        "nnmf": lambda: nt.nnmf(X, 3, maxiter=2, device="cpu"),
        "nnmf_multmse": lambda: nt.nnmf(X, 3, alg="multmse", init="random",
                                        maxiter=2, device="cpu"),
        "solve_replicates": lambda: nt.solve_replicates(
            cd, Xt, W, H, replicates=2, initH=True, device="cpu"),
        "nndsvd": lambda: nt.nndsvd(Xt, 3, variant="ar", device="cpu"),
        "nnmf_mesh": lambda: nt.nnmf(Xt, 3, maxiter=2, device="cpu",
                                     mesh=nt.make_mesh((1, 2), devices=["cpu"] * 2)),
        "rsvd": lambda: nt.rsvd(X, 3, device="cpu"),
        "nnmf_parallel_replicates": lambda: nt.nnmf(
            Xt, 3, alg="cd", init="random", replicates=3, maxiter=2,
            device="cpu", parallel_replicates=True),
        "solve_lanes": lambda: solve_lanes(
            cd, Xd, torch.stack([W, W]), torch.stack([H, H]), device="cpu"),
        "nnmf_dense_mesh": lambda: nt.nnmf(
            X, 3, alg="cd", init="random", maxiter=2, device="cpu",
            mesh=nt.make_mesh((2, 2), devices=["cpu"] * 4)),
        "solve_local_store_mesh": lambda: nt.solve(cd, nt.shard_tiled(
            r, c, X[r, c], X.shape, nt.make_mesh((1, 2), devices=["cpu"] * 2),
            local=True), W, H, device="cpu"),
        "warmup": lambda: nt.warmup(algs=("cd",), inits=("random",), device="cpu"),
    }


@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_compute_at_ieee_and_give_the_setting_back(
        name, caller, monkeypatch, tmp_path):
    seen = []
    mm = matops.mm

    def recording_mm(X, D):
        seen.append(MATMUL.fp32_precision)
        return mm(X, D)

    monkeypatch.setattr(matops, "mm", recording_mm)
    call = _entry_points(tmp_path)[name]
    CALLERS[caller][0]()
    call()
    assert seen and set(seen) == {"ieee"}, seen
    _caller_is_back(caller)


def _solver_entry_points():
    """The entry points of projected ALS, ALS projected gradient, SPA and
    FNNLS, on dense X and on the store."""
    X, Xt, W, H = _problem()
    Xd = torch.from_numpy(X)
    return {
        "nnmf_projals": lambda: nt.nnmf(X, 3, alg="projals", maxiter=2, device="cpu"),
        "nnmf_alspgrad_store": lambda: nt.nnmf(Xt, 3, alg="alspgrad", init="random",
                                               maxiter=2, device="cpu"),
        "nnmf_spa_store": lambda: nt.nnmf(Xt, 3, alg="spa", init="spa", device="cpu"),
        "alspgrad_updateh": lambda: nt.alspgrad_updateh(Xd, W, H, maxiter=5, device="cpu"),
        "alspgrad_updatew_store": lambda: nt.alspgrad_updatew(Xt, W, H, maxiter=5,
                                                              device="cpu"),
        "spa": lambda: nt.spa(Xd, 3, device="cpu"),
        "fnnls": lambda: nt.fnnls(W, Xd, device="cpu"),
        "nnls_gram": lambda: nt.nnls_gram(W.T @ W, W.T @ Xd, device="cpu"),
    }


@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("name", sorted(_solver_entry_points()))
def test_solver_entry_points_compute_at_ieee_and_give_the_setting_back(
        name, caller, monkeypatch):
    """As above, with the setting also recorded at ``matops.mtm`` and at
    FNNLS's batched solve, which some of these reach instead of
    ``matops.mm``."""
    from nmf_tpu_torch.ops import fnnls

    seen = []

    def recording(f):
        def call(*a):
            seen.append(MATMUL.fp32_precision)
            return f(*a)
        return call

    for mod, attr in ((matops, "mm"), (matops, "mtm"), (fnnls, "_masked_solve")):
        monkeypatch.setattr(mod, attr, recording(getattr(mod, attr)))
    call = _solver_entry_points()[name]
    CALLERS[caller][0]()
    call()
    assert seen and set(seen) == {"ieee"}, seen
    _caller_is_back(caller)


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_the_setting_comes_back_when_a_solve_raises(caller, monkeypatch):
    def failing_mm(X, D):
        assert MATMUL.fp32_precision == "ieee"
        raise FloatingPointError("from inside the solve")

    monkeypatch.setattr(matops, "mm", failing_mm)
    X, Xt, W, H = _problem()
    CALLERS[caller][0]()
    with pytest.raises(FloatingPointError, match="inside the solve"):
        nt.solve(nt.CoordinateDescent(maxiter=2), Xt, W, H, device="cpu")
    _caller_is_back(caller)
    # and when the front door refuses its arguments
    with pytest.raises(ValueError, match="k should not exceed"):
        nt.nnmf(X, 50, device="cpu")
    _caller_is_back(caller)


def test_scopes_nest_and_restore_in_order():
    _new_tf32()
    with config.precision_scope():
        assert MATMUL.fp32_precision == "ieee"
        with config.precision_scope():
            assert MATMUL.fp32_precision == "ieee"
        assert MATMUL.fp32_precision == "ieee"
    assert MATMUL.fp32_precision == "tf32"
    # torch's defaults come back as they were
    _default_precision()
    with config.precision_scope():
        assert MATMUL.fp32_precision == "ieee"
    assert MATMUL.fp32_precision == "none"
    assert torch.get_float32_matmul_precision() == "highest"


def test_the_scope_touches_no_cudnn_setting():
    before = torch.backends.cudnn.allow_tf32
    with config.precision_scope():
        assert torch.backends.cudnn.allow_tf32 == before
    assert torch.backends.cudnn.allow_tf32 == before


def test_import_after_a_legacy_call_leaves_the_legacy_reading_working():
    """torch refuses to answer ``get_float32_matmul_precision()`` once the
    legacy and the new API were both written; the import writes neither."""
    code = (
        "import torch\n"
        "torch.set_float32_matmul_precision('high')\n"
        "import nmf_tpu_torch\n"
        "print('AFTER', torch.get_float32_matmul_precision(),\n"
        "      torch.backends.cuda.matmul.fp32_precision)\n"
        "with nmf_tpu_torch.config.precision_scope():\n"
        "    print('INSIDE', torch.backends.cuda.matmul.fp32_precision)\n"
        "print('BACK', torch.get_float32_matmul_precision())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "AFTER high tf32" in out.stdout, out.stdout
    assert "INSIDE ieee" in out.stdout, out.stdout
    assert "BACK high" in out.stdout, out.stdout
