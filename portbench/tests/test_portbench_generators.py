"""The generators: the stated shape and exact count of distinct entries on
the rating grid, the same data from the same seed, other data from another;
the dense matrix's signal and noise."""

import pytest
import torch

from pb_support import ROOT, SIZES, card  # noqa: F401

from portbench.manifest import _read, load_module

RATINGS = load_module(ROOT / "portbench/generators/powerlaw_ratings.py")
BLOCKS = load_module(ROOT / "portbench/generators/powerlaw_blocks.py")
LOWRANK = load_module(ROOT / "portbench/generators/lowrank_noisy.py")
ML = _read(ROOT / "portbench/configs/ml25m-k128.json")
DENSE = _read(ROOT / "portbench/configs/dense100k-k64.json")
NORTHSTAR = _read(ROOT / "portbench/configs/northstar-2x2-k256.json")


def check_ratings(cfg, data):
    p, n = data["shape"]
    assert (p, n) == (cfg["rows"], cfg["cols"])
    rows, cols, vals = data["rows"].long(), data["cols"].long(), data["vals"]
    assert rows.numel() == cols.numel() == vals.numel() == cfg["nnz"]
    keys = rows * n + cols
    assert bool((keys[1:] > keys[:-1]).all())  # distinct, row-major
    assert int(rows.min()) >= 0 and int(rows.max()) < p
    assert int(cols.min()) >= 0 and int(cols.max()) < n
    levels = vals / cfg["rating_step"]
    assert bool((levels == levels.round()).all())
    assert set(levels.round().long().unique().tolist()) <= set(range(1, cfg["rating_levels"] + 1))


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 3_000_000_017])
def test_ratings_exact_count_on_the_grid(seed):
    cfg = dict(ML, **SIZES["ml25m-k128"])
    check_ratings(cfg, RATINGS.make(cfg, seed, "cpu"))


def test_ratings_repeat_from_a_seed():
    cfg = dict(ML, **SIZES["ml25m-k128"])
    a, b, c = (RATINGS.make(cfg, s, "cpu") for s in (7, 7, 8))
    for key in ("rows", "cols", "vals"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["rows"], c["rows"])


def test_ratings_power_law_rows():
    """A few rows hold many of the entries: the heaviest 1 % of rows hold
    more than a tenth of them."""
    cfg = dict(ML, rows=20000, cols=8000, nnz=200_000)
    deg = torch.bincount(RATINGS.make(cfg, 3, "cpu")["rows"].long(), minlength=20000)
    assert float(deg.sort(descending=True).values[:200].sum()) > 0.1 * 200_000


@pytest.mark.gpu
def test_ratings_full_size(card):
    """MovieLens 25M's shape and exactly 25,000,095 distinct pairs."""
    check_ratings(ML, RATINGS.make(ML, 3_000_000_019, card))


def test_lowrank_noisy():
    cfg = dict(DENSE, **SIZES["dense100k-k64"])
    X = LOWRANK.make(cfg, 11, "cpu")["X"]
    assert X.shape == (cfg["rows"], cfg["cols"]) and X.dtype == torch.float32
    assert float(X.min()) >= 0
    assert torch.equal(X, LOWRANK.make(cfg, 11, "cpu")["X"])
    s = torch.linalg.svdvals(X.double())
    # rank-8 signal: the 9th singular value is at the noise's level
    assert float(s[cfg["signal_rank"]]) < 0.02 * float(s[cfg["signal_rank"] - 1])


def test_blocks_raise_without_blocks_and_cut_the_same_draw():
    """Called as a harness that does not cut X over a mesh would call it,
    the generator raises; the four blocks of a 2 x 2 cut hold the whole
    matrix's entries between them, each in row-major order."""
    cfg = dict(NORTHSTAR, **SIZES["northstar-2x2-k256"])
    with pytest.raises(ValueError, match="mesh"):
        BLOCKS.make(cfg, 5, "cpu")
    p, n = cfg["rows"], cfg["cols"]
    whole = BLOCKS.make(cfg, 5, "cpu", [((0, p), (0, n))])
    check_ratings(cfg, whole)
    assert torch.equal(whole["rows"], RATINGS.make(cfg, 5, "cpu")["rows"])
    cuts = [((0, 2048), (0, 1024)), ((0, 2048), (1024, n)), ((2048, p), (0, 1024)),
            ((2048, p), (1024, n))]
    parts = [BLOCKS.make(cfg, 5, "cpu", [cut]) for cut in cuts]
    assert sum(len(b["vals"]) for b in parts) == cfg["nnz"]
    for ((r0, r1), (c0, c1)), b in zip(cuts, parts):
        r, c = b["rows"].long(), b["cols"].long()
        assert bool(((r >= r0) & (r < r1) & (c >= c0) & (c < c1)).all())
        assert bool((r * n + c).diff().gt(0).all())
    two = BLOCKS.make(cfg, 5, "cpu", cuts[1:3])
    assert len(two["vals"]) == len(parts[1]["vals"]) + len(parts[2]["vals"])
