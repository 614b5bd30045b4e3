"""The port's host library (``nmf_tpu_torch/csrc/host/nmf_host.cpp``,
reached through ``nmf_tpu_torch.io.loader``) against the JAX package's numpy
route and the port's own plain versions: every binner helper exactly, the
tiled stores array for array, ``shard_tiled`` block for block, the Matrix
Market parser entry for entry (order included) and ``coo_to_csr`` bit for
bit.  The library is compiled here with the host's C++ compiler."""

import collections
import contextlib
import dataclasses
import gzip

import numpy as np
import pytest
import torch

from nmf_tpu.io import loader as jl
from nmf_tpu.ops import sparse_format as jsf
from nmf_tpu_torch import convert
from nmf_tpu_torch.io import loader as tl
from nmf_tpu_torch.io import native
from nmf_tpu_torch.ops import sparse_format as tsf
from nmf_tpu_torch.ops import sparse_shard
from nmf_tpu_torch.parallel.mesh import make_mesh

from torch_parity import jax_tiled_to_dict

N = 200_000  # elements a helper case: above the library's 1 << 16
BINNER = ("nmf_argsort64", "nmf_gather3", "nmf_tile_key", "nmf_gather3k",
          "nmf_class_extract", "nmf_chunk_fill", "nmf_dense_scatter")


@pytest.fixture
def jax_numpy_route(monkeypatch):
    """The JAX package's loader without its native library: its numpy
    route."""
    monkeypatch.setattr(jl, "_LIB", None)
    monkeypatch.setattr(jl, "_LIB_TRIED", True)


class _Spy:
    """The host library, counting the entry points looked up on it."""

    def __init__(self, lib):
        self.lib, self.calls = lib, collections.Counter()

    def __getattr__(self, name):
        self.calls[name] += 1
        return getattr(self.lib, name)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(native.load())
    monkeypatch.setattr(native, "_lib", s)
    return s


def _tiles(rng, n, max_count=40):
    """Per-tile counts summing to ``n`` (many tiles of one entry, some full
    ones), their first entries and a class-major destination order."""
    counts = rng.integers(1, max_count, n)
    counts = counts[np.cumsum(counts) <= n]
    counts[-1] += n - counts.sum()
    t_first = np.cumsum(counts) - counts
    return counts.astype(np.int64), t_first.astype(np.int64)


def _helper_args(name, rng, n):
    """Arguments of one helper call over ``n`` elements: heavy key ties, a
    key above 2**40, rows and columns up to 2**30."""
    r = rng.integers(0, 1 << 30, n).astype(np.int32)
    c = rng.integers(0, 1 << 30, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    keys = rng.integers(0, 40, n).astype(np.int64)
    keys[::7] = (1 << 41) + rng.integers(0, 3, len(keys[::7]))
    keys[::11] = rng.integers(0, 1 << 45, len(keys[::11]))
    order = rng.integers(0, n, n)  # repeats: a gather is not a permutation
    if name == "stable_argsort":
        return (keys,)
    if name == "gather3":
        return order, r, c, v
    if name == "gather3k":
        return order, r, c, v, keys
    if name == "tile_key":
        return r, c, 1 << 23, 32
    if name == "dense_scatter":
        nblk = -(-n * 3 // 2 // (128 * 128))
        flat = rng.choice(nblk * 128 * 128, n, replace=False)
        blk, rest = np.divmod(flat, 128 * 128)
        lcol, lrow = np.divmod(rest, 128)
        return (np.zeros((nblk, 128, 128), np.float32), blk.astype(np.int64),
                lcol.astype(np.int64), lrow.astype(np.int64), v)
    counts, t_first = _tiles(rng, n)
    if name == "chunk_fill":
        nchunks = -(-counts // 128)
        base = np.cumsum(nchunks) - nchunks + rng.integers(0, 2, len(counts)).cumsum()
        slots = int(base[-1] + nchunks[-1]) * 128
        return (t_first, counts, base, r & 0xFFFF, c & 0xFFFF, v, 512,
                np.zeros(slots, np.int32), np.zeros(slots, np.float32))
    # class_extract: tiles dealt to four classes, each class's tiles in order
    cls = rng.integers(0, 4, len(counts))
    dst = np.empty(len(counts), np.int64)
    base = 0
    for k in range(4):
        m = cls == k
        dst[m] = base + np.cumsum(counts[m]) - counts[m]
        base += int(counts[m].sum())
    return t_first, counts, dst, r, c, v, order.astype(np.int64)


def _call(fn, name, args):
    """The helper's outputs, with the arrays it fills in place."""
    args = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
    out = fn(*args)
    if name == "dense_scatter":
        return (args[0],)
    if name == "chunk_fill":
        return out, args[7], args[8]
    return out if isinstance(out, tuple) else (out,)


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


HELPERS = ("stable_argsort", "gather3", "gather3k", "tile_key", "dense_scatter",
           "chunk_fill", "class_extract")


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_both_references(name, jax_numpy_route, spy):
    args = _helper_args(name, np.random.default_rng(HELPERS.index(name)), N)
    got = _call(getattr(tl, name), name, args)
    assert sum(spy.calls.values()) == 1  # the library ran it
    _assert_same(got, _call(getattr(tl, f"_{name}_plain"), name, args))
    _assert_same(got, _call(getattr(jl, name), name, args))


def test_helpers_below_the_threshold_stay_in_numpy(monkeypatch):
    def refuse():
        raise AssertionError("the library was loaded for a small call")

    monkeypatch.setattr(native, "load", refuse)
    for i, name in enumerate(HELPERS):
        args = _helper_args(name, np.random.default_rng(i), tl.NATIVE_MIN - 1)
        _assert_same(_call(getattr(tl, name), name, args),
                     _call(getattr(tl, f"_{name}_plain"), name, args))


def test_out_of_range_indices_raise(monkeypatch):
    """The library checks every index it reads or writes through and
    writes nothing out of bounds; the wrappers raise as numpy's indexing
    does."""
    monkeypatch.setattr(tl, "NATIVE_MIN", 1)
    rng = np.random.default_rng(9)
    order, r, c, v = _helper_args("gather3", rng, 1000)
    order[500] = len(r)
    for fn in (tl.gather3, tl._gather3_plain):
        with pytest.raises(IndexError):
            fn(order, r, c, v)
    dvals, blk, lcol, lrow, v = _helper_args("dense_scatter", rng, 1000)
    blk[7] = len(dvals)
    for fn in (tl.dense_scatter, tl._dense_scatter_plain):
        with pytest.raises(IndexError):
            fn(dvals.copy(), blk, lcol, lrow, v)
    args = list(_helper_args("class_extract", rng, 1000))
    args[2][-1] = 1000  # a tile's run past the outputs
    for fn in (tl.class_extract, tl._class_extract_plain):
        with pytest.raises(IndexError):
            fn(*args)
    args = list(_helper_args("chunk_fill", rng, 1000))
    args[2][-1] += 1  # the last tile's chunks past the store
    for fn in (tl.chunk_fill, tl._chunk_fill_plain):
        with pytest.raises(IndexError):
            fn(*args)
    with pytest.raises(ValueError, match="negative"):
        tl.tile_key(np.array([-1], np.int32), np.array([0], np.int32), 4, 2)


def _power_law(seed=0, p=20_000, n=9_000, nnz=260_000):
    """``benchmarks/run.py``'s power-law matrix at a small size (about
    200,000 distinct entries)."""
    rng = np.random.default_rng(seed)
    rows = np.minimum(rng.pareto(1.2, nnz) * p / 50, p - 1).astype(np.int64)
    cols = np.minimum(rng.pareto(1.2, nnz) * n / 50, n - 1).astype(np.int64)
    rows, cols = rng.permutation(p)[rows], rng.permutation(n)[cols]
    key = np.unique(rows * n + cols)
    vals = (rng.random(len(key)) * 4 + 1).astype(np.float32)
    return (key // n).astype(np.int32), (key % n).astype(np.int32), vals, (p, n)


def _assert_stores_equal(a, b):
    """Two of the port's TiledCSR stores, every field of both sides."""
    assert a.shape == b.shape and a.build_opts == b.build_opts
    for x, y in ((a, b), (a.fwd, b.fwd), (a.bwd, b.bwd)):
        for f in dataclasses.fields(y):
            if f.name in ("fwd", "bwd"):
                continue
            u, w = getattr(x, f.name), getattr(y, f.name)
            if isinstance(w, torch.Tensor):
                assert u.dtype == w.dtype and torch.equal(u, w), f.name
            else:
                assert u == w, f.name


@pytest.mark.parametrize("opts", [dict(dense_tile_nnz=192, coo_tail_nnz=3),
                                  dict(dense_tile_nnz=192, quad_tail_nnz=32)],
                         ids=["chunk_band", "quad"])
def test_store_matches_jax(opts, jax_numpy_route, spy, monkeypatch):
    """The power-law matrix as the card's stores are built from it; the
    library's threshold lowered so that the smaller classes' passes take it
    too."""
    monkeypatch.setattr(tl, "NATIVE_MIN", 1024)
    r, c, v, shape = _power_law()
    assert len(v) > N
    Xt = tsf.build_tiled(r, c, v, shape, device="cpu", **opts)
    assert set(BINNER) <= set(spy.calls)
    Xj = jsf.build_tiled(r, c, v, shape, **opts)
    for side in (Xt.fwd, Xt.bwd):
        assert side.n_dblocks and side.panel_chunks.numel()
        assert side.n_coo if "coo_tail_nnz" in opts else side.n_qchunks
    _assert_stores_equal(Xt, convert.tiled_from_numpy(jax_tiled_to_dict(Xj), device="cpu"))


def test_shard_tiled_native_equals_plain(monkeypatch, spy):
    """A 2 x 2 CPU mesh: every block's helpers take the library (its
    threshold lowered so that the blocks' arrays pass it) and give the
    blocks of the plain route."""
    monkeypatch.setattr(tl, "NATIVE_MIN", 1024)
    r, c, v, shape = _power_law(seed=1)
    mesh = make_mesh((2, 2), devices=["cpu"] * 4)
    opts = dict(dense_tile_nnz=192, quad_tail_nnz=32, coo_tail_nnz=3)
    Xn = sparse_shard.shard_tiled(r, c, v, shape, mesh, **opts)
    assert set(BINNER) <= set(spy.calls)
    native_calls = sum(spy.calls.values())
    with tl._plain_route():
        Xp = sparse_shard.shard_tiled(r, c, v, shape, mesh, **opts)
    assert sum(spy.calls.values()) == native_calls  # none on the plain route
    for name in ("row_perm", "row_rank", "col_perm", "col_rank", "stats"):
        assert torch.equal(getattr(Xn, name), getattr(Xp, name)), name
    assert Xn.block_nnz == Xp.block_nnz
    for (_, _, a), (_, _, b) in zip(Xn.owned(), Xp.owned(), strict=True):
        _assert_stores_equal(a, b)


MTX = {
    "general": ("real general", ["3 2 1.5", "1 1 -2.25", "3 2 0.125", "2 4 7e-3"]),
    "pattern": ("pattern general", ["2 1", "3 4", "1 1"]),
    "integer": ("integer general", ["1 2 16777217", "3 3 -5", "2 1 9007199254740993"]),
    "symmetric": ("real symmetric", ["1 1 1.0", "2 1 2.5", "3 3 4.0", "4 2 -3.5", "4 1 6"]),
    "skew_symmetric": ("real skew-symmetric", ["2 1 1.5", "3 1 -2.0", "4 3 3.25"]),
    "hermitian": ("real hermitian", ["1 1 2.0", "3 1 -0.5", "4 2 1.25"]),
}


def _write_mtx(path, header, lines, shape=(4, 4)):
    body = "\n".join(lines)
    path.write_text(f"%%MatrixMarket matrix coordinate {header}\n% a comment\n"
                    f"{shape[0]} {shape[1]} {len(lines)}\n{body}\n")
    return path


@pytest.mark.parametrize("kind", MTX)
def test_load_mtx_matches_scipy_in_order(kind, tmp_path, spy):
    header, lines = MTX[kind]
    path = _write_mtx(tmp_path / f"{kind}.mtx", header, lines)
    got = tl.load_mtx(str(path))
    assert spy.calls["nmf_load_mtx"] == 1
    with tl._plain_route():
        want = tl.load_mtx(str(path))
    assert (got.rows, got.cols) == (want.rows, want.cols) == (4, 4)
    _assert_same(got[2:], want[2:])
    if kind == "general":  # a compressed file, which scipy reads
        gz = tmp_path / "general.mtx.gz"
        gz.write_bytes(gzip.compress(path.read_bytes()))
        _assert_same(tl.load_mtx(str(gz))[2:], want[2:])
    if kind == "skew_symmetric":  # the mirrors, after the entries, are -v
        np.testing.assert_array_equal(got.values, [1.5, -2.0, 3.25, -1.5, 2.0, -3.25])
        np.testing.assert_array_equal(got.row_idx, [1, 2, 3, 0, 0, 2])
    if kind == "hermitian":  # of real values: symmetric, mirrors +v
        np.testing.assert_array_equal(got.values, [2.0, -0.5, 1.25, -0.5, 1.25])


def _big_mtx(path, header, rng, n, shape, last=None):
    """A file of ``n`` entry lines in the lower triangle (every fifth on the
    diagonal) and no newline at its end: a blank line every thousand, or,
    with a ``last`` line written after them, none (a range's blank lines
    would leave room for a line it miscounted)."""
    r = rng.integers(1, shape[0] + 1, n)
    c = rng.integers(1, shape[1] + 1, n)
    r, c = np.maximum(r, c), np.minimum(r, c)
    c[::5] = r[::5]
    v = rng.standard_normal(n).astype(np.float32)
    lines = [f"{a} {b} {x!r}" for a, b, x in zip(r.tolist(), c.tolist(), v.tolist())]
    if last:
        lines.append(last)
    for i in range(len(lines) - 1000, 0, -1000) if not last else ():
        lines.insert(i, "" if i % 2000 else "  \t ")
    path.write_text(f"%%MatrixMarket matrix coordinate {header}\n"
                    f"{shape[0]} {shape[1]} {n + bool(last)}\n" + "\n".join(lines))
    return path


@pytest.mark.parametrize("case", ["symmetric", "skew-symmetric", "long_last_line"])
def test_load_mtx_many_ranges_match_scipy(case, tmp_path, spy):
    """Files of 3-6 MiB, which the parser cuts into ranges of lines, one a
    thread (one range a MiB, up to the host's cores): the mirrors written
    per range and the ranges joined in order give scipy's COO, order
    included.  In ``long_last_line`` the last line, with no newline, is
    longer than half the file, so the ranges after the first start at the
    file's end and the first range parses that line."""
    rng = np.random.default_rng(["symmetric", "skew-symmetric", "long_last_line"].index(case))
    shape = (700_000, 700_000)
    if case == "long_last_line":
        path = _big_mtx(tmp_path / "x.mtx", "real symmetric", rng, 60_000, shape,
                        last="3" + " " * (3 << 20) + "1 2.5")
    else:
        path = _big_mtx(tmp_path / "x.mtx", f"real {case}", rng, 250_000, shape)
    assert path.stat().st_size > 3 << 20 and path.read_bytes()[-1:] != b"\n"
    got = tl.load_mtx(str(path))
    assert spy.calls["nmf_load_mtx"] == 1
    with tl._plain_route():
        want = tl.load_mtx(str(path))
    assert (got.rows, got.cols) == (want.rows, want.cols) == shape
    assert len(want.values) > 1.5 * (60_000 if case == "long_last_line" else 250_000)
    _assert_same(got[2:], want[2:])


def test_load_mtx_refuses_what_it_cannot_read(tmp_path):
    for header, line in (("complex general", "2 1 1.5 2.0"),
                         ("complex hermitian", "2 1 1.5 2.0")):
        path = _write_mtx(tmp_path / "x.mtx", header, [line])
        for plain in (False, True):
            with tl._plain_route() if plain else contextlib.nullcontext():
                with pytest.raises(ValueError):
                    tl.load_mtx(str(path))
    path = tmp_path / "dense.mtx"
    path.write_text("%%MatrixMarket matrix array real general\n2 1\n1.0\n2.0\n")
    with pytest.raises(ValueError):
        tl.load_mtx(str(path))
    with pytest.raises(FileNotFoundError):
        tl.load_mtx(str(tmp_path / "missing.mtx"))


def test_coo_to_csr_bits(jax_numpy_route, spy):
    """Three or more entries at most positions, long rows (scipy sorts each
    row) and the same entries already in row and column order (scipy keeps
    their order)."""
    rng = np.random.default_rng(5)
    p, n, nnz = 300, 60, 150_000
    rows = rng.integers(0, p, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = (rng.random(nnz) * 10.0 ** rng.uniform(-4, 4, nnz)).astype(np.float32)
    o = np.lexsort((cols, rows))
    for r, c, v in ((rows, cols, vals), (rows[o], cols[o], vals[o])):
        coo = tl.COO(p, n, r, c, v)
        got = tl.coo_to_csr(coo)
        with tl._plain_route():
            want = tl.coo_to_csr(coo)
        _assert_same(got[2:], want[2:])
        _assert_same(got[2:], jl.coo_to_csr(jl.COO(p, n, r, c, v))[2:])
        assert len(got.data) <= nnz // 8  # eight entries a position on average
    assert spy.calls["nmf_coo_to_csr"] == 2
    with pytest.raises(ValueError, match="out of range"):
        tl.coo_to_csr(tl.COO(2, 2, np.array([0, 2], np.int32),
                             np.array([0, 1], np.int32), np.ones(2, np.float32)))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source that does not compile: the call that takes
    the library raises with the reason, and never falls back to numpy."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", ("no-such-compiler++",))
    path = _write_mtx(tmp_path / "a.mtx", *MTX["general"])
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tl.load_mtx(str(path))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tl.stable_argsort(np.arange(N))
    assert not tl.native_available()
    monkeypatch.setattr(native, "CXX", ("g++", "c++"))
    broken = tmp_path / "nmf_host.cpp"
    broken.write_text("extern \"C\" int nmf_free( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed on nmf_host.cpp") as e:
        tl.coo_to_csr(tl.COO(1, 1, np.zeros(1, np.int32), np.zeros(1, np.int32),
                             np.ones(1, np.float32)))
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
