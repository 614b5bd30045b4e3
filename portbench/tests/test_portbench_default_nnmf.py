"""A traffic mix that calls ``nnmf`` with its own init and tolerance
(``DEFAULT``, ``nnmf(X, k)`` with every default, in no cell yet): the
frozen copy of the NNDSVD draw and the plain GreedyCD against the port's
own on the CPU, and the harness's calls, window and check for such a mix
and for the cells' mixes, which start from the window's ``W0``, ``H0``."""

import pytest
import torch

from pb_support import SIZES, cell_names, tiny_cell

import nmf_tpu_torch as nt
from nmf_tpu_torch.init.initialization import child_generators, nndsvd
from portbench import check, harness
from portbench.reference import common as refc
from portbench.reference import greedycd as ref_greedycd
from portbench.reference import nndsvd as ref_nndsvd

CPU = torch.device("cpu")
VARIANT = {"nndsvd": "std", "nndsvda": "a", "nndsvdar": "ar"}


# ``nnmf(X, k)`` with every default: NNDSVD-ar, GreedyCD, nnmf's own tol
DEFAULT = {"alg": "greedycd", "kind": "iterations", "init": "nndsvdar", "maxiter": 100,
           "tol": None}


def default_cell():
    """``ml25m-k128`` at the tests' size under ``DEFAULT``, with no
    limits: a cell that ``BENCHMARK.json`` leaves out until a number
    separates the program from the control (``PERF.md``)."""
    cell = tiny_cell("ml25m-kl")
    cell.name, cell.traffic, cell.limits = "ml25m-greedycd-default", dict(DEFAULT), {}
    assert cell.config["rank"] == SIZES["ml25m-k128"]["rank"]
    return cell


def ratings(p=300, n=200, k=8, seed=5):
    """A non-negative X of rank k plus noise with a third of its entries
    zero, dense, and its entries as the reference takes them."""
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(p, k, generator=g) @ torch.rand(k, n, generator=g)
    X = X + 0.05 * torch.rand(p, n, generator=g)
    X = X * (torch.rand(p, n, generator=g) > 1 / 3)
    r, c = X.nonzero(as_tuple=True)
    return X, {"kind": "sparse", "shape": (p, n), "rows": r.int(), "cols": c.int(),
               "vals": X[r, c]}


# the port's basis (shifted CholeskyQR3) leaves its columns 1 / sqrt(1 +
# l^2 eps) long, l = k + 10 = 18 here, and its W and H that much smaller
SHIFT = 18 * 18 * refc.EPS32


@pytest.mark.parametrize("operand", ["sparse", "dense"])
@pytest.mark.parametrize("init", ["nndsvd", "nndsvda", "nndsvdar"])
def test_nndsvd_start_is_the_ports(init, operand):
    X, entries = ratings()
    k, seed = 8, 2**33 + 17
    ginit = child_generators(torch.Generator().manual_seed(seed), 3)[0]
    W, H = nndsvd(X, k, variant=VARIANT[init], generator=ginit, device="cpu")
    Xref = refc.operand(entries) if operand == "sparse" else X
    Wr, Hr = ref_nndsvd.start(init, Xref, k, seed, CPU)
    assert Wr.dtype == Hr.dtype == torch.float64
    assert check.gap(W, Wr) < SHIFT and check.gap(H, Hr) < SHIFT
    if init != "nndsvd":  # the fill: every entry off a kept side
        assert bool((W > 0).all()) and bool((Wr > 0).all())
    # the control's start: float32, TF32 products, off the exact one
    Wl, Hl = ref_nndsvd.start(init, Xref, k, seed, CPU, low=True)
    assert Wl.dtype == Hl.dtype == torch.float32
    assert bool(Wl.isfinite().all()) and bool(Hl.isfinite().all())
    assert check.gap(Wl, Wr) > SHIFT and check.gap(Hl, Hr) > SHIFT


def test_nndsvd_start_leaves_h_zero_for_projals():
    X, _ = ratings()
    W, H = ref_nndsvd.start("nndsvdar", X, 8, 3, CPU, zeroh=True)
    assert W.shape == (300, 8) and not bool(H.any())
    with pytest.raises(ValueError):
        ref_nndsvd.start("spa", X, 8, 3, CPU)


@pytest.mark.parametrize("operand", ["sparse", "dense"])
def test_greedycd_reference_is_the_ports(operand):
    """Ten iterations from one start, both in float64: the same greedy
    schedule, so the same factors to the order of the products' sums."""
    X, entries = ratings(p=120, n=90, k=6)
    X64 = X.double()
    g = torch.Generator().manual_seed(11)
    W0 = torch.rand(120, 6, generator=g, dtype=torch.float64)
    H0 = torch.rand(6, 90, generator=g, dtype=torch.float64)
    res = nt.nnmf(X64, 6, init="custom", W0=W0, H0=H0, alg="greedycd", maxiter=10,
                  tol=1e-30, device="cpu")
    assert res.niters == 10
    if operand == "sparse":
        entries["vals"] = entries["vals"].double()
        Xref = refc.operand(entries)
    else:
        Xref = X64
    W, H = ref_greedycd.solve(Xref, W0, H0, 10, refc.Products(False))
    assert check.gap(res.W, W) < 1e-7 and check.gap(res.H, H) < 1e-7
    assert ref_greedycd.objective(Xref, W, H) == pytest.approx(float(res.objvalue), rel=1e-9)


def test_greedycd_reference_stops_rows_on_their_own():
    """A row already at its optimum takes no step, whatever the others do."""
    H = torch.tensor([[1.0, 0.0], [0.0, 1.0]], dtype=torch.float64)
    X = torch.tensor([[2.0, 3.0], [5.0, 0.5]], dtype=torch.float64)
    W0 = torch.tensor([[2.0, 3.0], [0.0, 0.0]], dtype=torch.float64)
    W = ref_greedycd._halfstep(lambda D: X @ D, W0, H.T, refc.Products(False))
    assert torch.equal(W[0], W0[0])
    torch.testing.assert_close(W[1], X[1])


class Recorder:
    def __init__(self, monkeypatch):
        self.calls = []
        nnmf = nt.nnmf

        def record(X, k, **kw):
            self.calls.append(dict(kw))
            return nnmf(X, k, **kw)

        monkeypatch.setattr(nt, "nnmf", record)


def small_solver(cell):
    X, _ = ratings(p=60, n=40, k=4)
    return harness.Solver(nt, X, 4, cell.traffic, CPU, float((X.double() ** 2).sum())), X


def test_solver_hands_nnmf_its_own_init(monkeypatch):
    cell = default_cell()
    rec = Recorder(monkeypatch)
    solve, X = small_solver(cell)
    W0, H0 = harness.solve_start(cell.traffic, X.shape, 4, CPU, 9, 0)
    assert W0 is None and H0 is None
    ans = solve(W0, H0, harness.nnmf_seed(9, 0), warm=True)
    (kw,) = rec.calls
    assert kw["init"] == "nndsvdar" and kw["tol"] is None and kw["maxiter"] == 2
    assert "W0" not in kw and "H0" not in kw
    assert kw["seed"] == harness.nnmf_seed(9, 0) and ans.niters <= 2


@pytest.mark.parametrize("name", cell_names())
def test_solver_hands_nnmf_the_windows_start(name, monkeypatch):
    """The mixes that leave ``init`` and ``tol`` out: the window's
    ``W0``, ``H0`` and the mix's ``tol``, as before these keys existed."""
    cell = tiny_cell(name)
    rec = Recorder(monkeypatch)
    solve, X = small_solver(cell)
    W0, H0 = harness.solve_start(cell.traffic, X.shape, 4, CPU, 9, 3)
    Wd, Hd = harness.draw_start(X.shape, 4, CPU, 9, 3)
    assert torch.equal(W0, Wd) and torch.equal(H0, Hd)
    tr = cell.traffic
    solve(W0, H0, 123, warm=True)
    want = dict(alg=tr["alg"], init="custom", tol=tr["tol"], device=CPU, mesh=None, seed=123,
                replicates=tr.get("replicates", 1),
                parallel_replicates=tr.get("parallel_replicates", False),
                maxiter=2 if tr["kind"] == "iterations" else tr["chunk"])
    kw = rec.calls[0]
    assert kw.pop("W0") is W0 and kw.pop("H0") is H0
    assert kw == want


def test_lane_starts_work_the_init_out_again():
    cell = default_cell()
    X, entries = ratings()
    seed, index = 2**40 + 1, 4
    (W, H), = check.lane_starts(cell, (300, 200), seed, index, CPU, refc.operand(entries))
    ginit = child_generators(torch.Generator().manual_seed(harness.nnmf_seed(seed, index)),
                             3)[0]
    Wp, Hp = nndsvd(X, cell.config["rank"], variant="ar", generator=ginit, device="cpu")
    # l = 16 + 10 at the test's size
    assert check.gap(Wp, W) < 26 * 26 * refc.EPS32 and check.gap(Hp, H) < 26 * 26 * refc.EPS32


def test_reference_runs_the_kept_solves_own_count_at_the_default_tol():
    ans = harness.Answer(None, None, 37)
    assert check.iterations({"kind": "iterations", "maxiter": 100, "tol": None}, ans) == 37
    assert check.iterations({"kind": "iterations", "maxiter": 20, "tol": 1e-30}, ans) == 20
    assert check.iterations({"kind": "target", "maxiter": 20, "tol": 1e-30}, ans) == 37


def test_a_mix_states_its_tol(monkeypatch):
    """Solver and check read ``tol`` alike: a mix without the key fails in
    both, rather than one running to nnmf's default and the other to
    ``maxiter``."""
    cell = default_cell()
    del cell.traffic["tol"]
    solve, X = small_solver(cell)
    with pytest.raises(KeyError):
        solve(None, None, 1, warm=True)
    with pytest.raises(KeyError):
        check.iterations(cell.traffic, harness.Answer(None, None, 3))


def test_a_window_of_the_default_mix(monkeypatch):
    """The window runs ``nnmf``'s init inside each timed call, and the check
    solves the reference from its own NNDSVD-ar start for the kept solve's
    own count of iterations."""
    cell = default_cell()
    cell.config = dict(cell.config, rows=600, cols=300, nnz=20000, rank=8)
    cell.traffic = dict(cell.traffic, maxiter=6)  # GreedyCD is slow on the CPU
    rec = Recorder(monkeypatch)
    ran = []
    answers = check.answers

    def counted(cell, X, lanes, iters, low):
        ran.append((iters, [w.dtype for w, _ in lanes]))
        return answers(cell, X, lanes, iters, low)

    monkeypatch.setattr(check, "answers", counted)
    cell.limits = {"obj_gap": 1.0}  # any limit: the numbers are computed
    res = harness.run_cell(cell, 2**35 + 3, 0.1, trace=False, device="cpu")
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(kw["init"] == "nndsvdar" and "W0" not in kw for kw in rec.calls)
    assert rec.calls[0]["maxiter"] == 2 and rec.calls[1]["maxiter"] == 6
    (iters, dtypes), = ran
    assert iters in res["spans"]["window_solves_iters"] and dtypes == [torch.float64]
    assert 0 <= res["checks"]["obj_gap"]["value"] < 1.0
