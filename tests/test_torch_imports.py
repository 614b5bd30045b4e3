"""The PyTorch build stands alone: it imports neither ``jax`` nor the JAX
package, and its entry points default to the card and refuse to run without
one."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nmf_tpu_torch as nt
from nmf_tpu_torch import config, convert
from nmf_tpu_torch.ops.sparse_format import build_tiled

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted(
    p for p in (ROOT / "nmf_tpu_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh") and "build" not in p.parts
) + [ROOT / "chip_smoke.py"]

MODULES = [
    "nmf_tpu_torch",
    "nmf_tpu_torch.config",
    "nmf_tpu_torch.convert",
    "nmf_tpu_torch.init.initialization",
    "nmf_tpu_torch.io.loader",
    "nmf_tpu_torch.models.alspgrad",
    "nmf_tpu_torch.models.checkpoint",
    "nmf_tpu_torch.models.common",
    "nmf_tpu_torch.models.coorddesc",
    "nmf_tpu_torch.models.greedycd",
    "nmf_tpu_torch.models.interface",
    "nmf_tpu_torch.models.multupd",
    "nmf_tpu_torch.models.projals",
    "nmf_tpu_torch.models.replicates",
    "nmf_tpu_torch.models.spa",
    "nmf_tpu_torch.ops.dense_shard",
    "nmf_tpu_torch.ops.fnnls",
    "nmf_tpu_torch.ops.linalg",
    "nmf_tpu_torch.ops.matops",
    "nmf_tpu_torch.ops.objectives",
    "nmf_tpu_torch.ops.rsvd",
    "nmf_tpu_torch.ops.sparse_format",
    "nmf_tpu_torch.ops.sparse_shard",
    "nmf_tpu_torch.ops.tsqr",
    "nmf_tpu_torch.ops.cuda.build",
    "nmf_tpu_torch.ops.cuda.elementwise",
    "nmf_tpu_torch.ops.cuda.mu",
    "nmf_tpu_torch.ops.cuda.objectives",
    "nmf_tpu_torch.ops.cuda.sparse",
    "nmf_tpu_torch.parallel.exchange",
    "nmf_tpu_torch.parallel.mesh",
    "nmf_tpu_torch.parallel.sharding",
    "nmf_tpu_torch.utils.dtypes",
    "nmf_tpu_torch.utils.numeric",
    "nmf_tpu_torch.utils.precompile",
]


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    # torch's precision settings, read the same way with and without the import
    settings = (
        "import torch\n"
        "print('SETTINGS', torch.backends.cuda.matmul.fp32_precision,\n"
        "      torch.get_float32_matmul_precision(),\n"
        "      torch.backends.cudnn.allow_tf32)\n"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'nmf_tpu', 'triton'))\n"
        "print('BAD', bad)\n"
        "from nmf_tpu_torch.ops.cuda import build\n"
        "print('BUILT', build._lib is not None or build.build_seconds is not None)\n"
    ) + settings
    out, alone = (
        subprocess.run([sys.executable, "-c", c], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
        for c in (code, settings))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # importing the package builds and loads no kernel
    assert "BUILT False" in out.stdout, out.stdout
    # the import leaves the caller's settings as they were
    assert alone.returncode == 0, alone.stderr
    assert "SETTINGS" in alone.stdout
    assert alone.stdout.splitlines()[-1] == out.stdout.splitlines()[-1], (
        out.stdout, alone.stdout)


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_the_jax_package_as_an_import(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+nmf_tpu(\.|\s)", text, re.M)
    assert "nmf_tpu." not in text.replace("nmf_tpu_torch.", "")


def test_every_source_of_the_port_is_checked():
    names = {p.name for p in PORT_SOURCES}
    assert {"chip_smoke.py", "chunk_matmul.cu", "dense_matmul.cu", "sparse.py",
            "interface.py", "chunk_sddmm.cu", "mu.cu", "objectives.cu",
            "quotient_tile.cuh", "mu.py", "objectives.py", "multupd.py",
            "greedycd.py", "quad_matmul.cu", "quad_sddmm.cu",
            "sddmm_piece.cuh", "elementwise.cu", "elementwise.py", "rsvd.py",
            "tsqr.py", "linalg.py", "initialization.py", "projals.py",
            "alspgrad.py", "spa.py", "fnnls.py", "checkpoint.py",
            "loader.py", "replicates.py", "dense_shard.py", "exchange.py",
            "precompile.py"} <= names


def test_every_module_of_the_port_is_imported_by_the_check():
    have = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT_SOURCES
        if p.suffix == ".py" and p.name not in ("__init__.py", "chip_smoke.py")
    }
    assert have <= set(MODULES), sorted(have - set(MODULES))


def test_build_lists_every_source_and_entry_point():
    from nmf_tpu_torch.ops.cuda import build

    on_disk = {p.name for p in build.CSRC.iterdir()}
    assert set(build.SOURCES) | set(build.HEADERS) == on_disk
    assert set(build.KERNELS) == {
        "chunk_matmul", "dense_matmul", "quad_matmul", "coo_matmul", "csr_matmul",
        "chunk_sddmm", "quad_sddmm", "mu_factor_update", "wtq", "qht",
        "dense_objective", "projectnn", "colsum", "scale_cols"}
    for name in build.KERNELS:
        assert any(f'extern "C" int nmf_{name}(' in (build.CSRC / s).read_text()
                   for s in build.SOURCES), name


def test_tf32_is_off():
    """TF32 is off inside ``config.precision_scope`` (cuBLAS at IEEE float32)
    and the caller's setting is back after it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        with config.precision_scope():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = saved


def _entry_points(tmp):
    from nmf_tpu_torch.io import loader
    from nmf_tpu_torch.models.replicates import solve_lanes
    from nmf_tpu_torch.ops.sparse_format import from_bcoo

    rng = np.random.default_rng(0)
    X = rng.random((12, 9)).astype(np.float32)
    r, c = np.nonzero(X)
    W, H = torch.rand(12, 3), torch.rand(3, 9)
    Xs = torch.from_numpy(X).to_sparse_csr()
    coo = loader.COO(12, 9, r.astype(np.int32), c.astype(np.int32), X[r, c])
    steps = iter(range(1000))
    Xt = build_tiled(r, c, X[r, c], X.shape, device="cpu")
    Xq = build_tiled(r, c, X[r, c], X.shape, device="cpu", quad_tail_nnz=32)
    return {
        "nnmf_greedycd": lambda **kw: nt.nnmf(X, 3, alg="greedycd", init="random", maxiter=2, **kw),
        "solve_greedycd_quad_store": lambda **kw: nt.solve(nt.GreedyCD(maxiter=2), Xq, W, H, **kw),
        "build_tiled_quad": lambda **kw: build_tiled(
            r, c, X[r, c], X.shape, quad_tail_nnz=32, **kw),
        "nnmf": lambda **kw: nt.nnmf(X, 3, alg="cd", init="random", maxiter=1, **kw),
        "nnmf_defaults": lambda **kw: nt.nnmf(X, 3, maxiter=2, **kw),
        "nnmf_defaults_tiled": lambda **kw: nt.nnmf(Xt, 3, maxiter=2, **kw),
        "nndsvd": lambda **kw: nt.nndsvd(X, 3, variant="ar", **kw),
        "rsvd": lambda **kw: nt.rsvd(X, 3, **kw),
        "solve": lambda **kw: nt.solve(nt.CoordinateDescent(maxiter=1), Xt, W, H, **kw),
        "nnmf_multmse": lambda **kw: nt.nnmf(X, 3, alg="multmse", init="random", maxiter=2, **kw),
        "nnmf_multdiv": lambda **kw: nt.nnmf(Xt, 3, alg="multdiv", init="random", maxiter=2, **kw),
        "solve_multupdate": lambda **kw: nt.solve(nt.MultUpdate(obj="div", maxiter=2), Xt, W, H, **kw),
        "result_from_numpy": lambda **kw: convert.result_from_numpy(
            dict(W=W.numpy(), H=H.numpy(), niters=1, converged=False, objvalue=0.0), **kw),
        "solve_replicates": lambda **kw: nt.solve_replicates(
            nt.CoordinateDescent(maxiter=1), Xt, W, H, replicates=1, initH=True, **kw),
        "randinit": lambda **kw: nt.randinit((12, 9), 3, **kw),
        "build_tiled": lambda **kw: build_tiled(r, c, X[r, c], X.shape, **kw),
        "factors_from_numpy": lambda **kw: convert.factors_from_numpy(
            W.numpy(), H.numpy(), **kw),
        "nnmf_projals": lambda **kw: nt.nnmf(X, 3, alg="projals", maxiter=2, **kw),
        "nnmf_alspgrad": lambda **kw: nt.nnmf(Xt, 3, alg="alspgrad", init="random",
                                              maxiter=2, **kw),
        "nnmf_spa": lambda **kw: nt.nnmf(Xt, 3, alg="spa", init="spa", **kw),
        "alspgrad_updateh": lambda **kw: nt.alspgrad_updateh(Xt, W, H, maxiter=5, **kw),
        "alspgrad_updatew": lambda **kw: nt.alspgrad_updatew(
            torch.from_numpy(X), W, H, maxiter=5, **kw),
        "spa": lambda **kw: nt.spa(torch.from_numpy(X), 3, **kw),
        "fnnls": lambda **kw: nt.fnnls(W, Xt, **kw),
        "nnls_gram": lambda **kw: nt.nnls_gram(W.T @ W, W.T @ torch.from_numpy(X), **kw),
        "separable_data": lambda **kw: nt.separable_data(8, 6, 2, **kw),
        "solve_checkpointed": lambda **kw: nt.solve_checkpointed(
            nt.CoordinateDescent(maxiter=2), Xt, W, H,
            checkpoint_dir=f"{tmp}/ck{next(steps)}", **kw),
        "nnmf_sparse_csr": lambda **kw: nt.nnmf(Xs, 3, alg="cd", init="random",
                                                maxiter=1, **kw),
        "nnmf_mesh": lambda **kw: nt.nnmf(
            Xt, 3, alg="cd", init="random", maxiter=1,
            mesh=nt.make_mesh((1, 2), devices=["cpu"] * 2), **kw),
        "nnmf_parallel_replicates": lambda **kw: nt.nnmf(
            Xt, 3, alg="greedycd", init="random", replicates=3, maxiter=2,
            parallel_replicates=True, **kw),
        "solve_lanes": lambda **kw: solve_lanes(
            nt.CoordinateDescent(maxiter=2), Xt, torch.stack([W, W]),
            torch.stack([H, H]), **kw),
        "nnmf_dense_mesh": lambda **kw: nt.nnmf(
            X, 3, alg="multdiv", init="random", maxiter=2,
            mesh=nt.make_mesh((1, 2), devices=["cpu"] * 2), **kw),
        "to_bcoo": lambda **kw: loader.to_bcoo(coo, **kw),
        "from_bcoo": lambda **kw: from_bcoo(Xs, **kw),
        "sparse_from_numpy": lambda **kw: convert.sparse_from_numpy(
            np.stack([r, c], 1), X[r, c], X.shape, **kw),
        "warmup": lambda **kw: nt.warmup(algs=("cd",), inits=("random",), **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points(None)))
def test_entry_point_defaults_to_the_card_and_raises_without_one(name, tmp_path):
    call = _entry_points(tmp_path)[name]
    call(device="cpu")  # runs on the CPU when asked to
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        call(device="cuda")


def test_resolve_device_and_check_on_device():
    assert config.DEFAULT_DEVICE == "cuda"
    assert config.resolve_device("cpu") == torch.device("cpu")
    t = torch.zeros(2)
    config.check_on_device(torch.device("cpu"), a=t, b=None)
    with pytest.raises(ValueError, match="a lives on cpu"):
        config.check_on_device(torch.device("cuda"), a=t)


def test_same_device_compares_the_whole_device(monkeypatch):
    dev = torch.device
    assert config.same_device(dev("cpu"), dev("cpu"))
    assert not config.same_device(dev("cpu"), dev("cuda:0"))
    assert config.same_device(dev("cuda:1"), dev("cuda:1"))
    assert not config.same_device(dev("cuda:1"), dev("cuda:0"))
    # ``cuda`` without an index is the current device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert config.same_device(dev("cuda"), dev("cuda:1"))
    assert not config.same_device(dev("cuda:0"), dev("cuda"))
    assert config.same_device(dev("cuda"), dev("cuda"))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr
