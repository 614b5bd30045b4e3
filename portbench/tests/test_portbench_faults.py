"""A run of each cell, past the harness's look for a card, with the solve
broken underneath, must come out not correct; the same run unbroken comes
out correct.  The faults a one-card solve can have:

- a step that returns its state unchanged (every solver's update, and the
  batched restarts' update, hand back W and H as they got them);
- half of the batch left out, the rest scaled up in its place (every
  product with X sees the first half of the shared dimension, doubled);
- an answer altered where it is produced (``nnmf``'s W has its heaviest row
  doubled).

A cell cut over a mesh runs here on a mesh of one process, with no
exchange; ``test_portbench_ranks.py`` leaves the exchange out between four
processes."""

import pytest

from pb_support import cell_names, run_tiny

import nmf_tpu_torch as nt
from nmf_tpu_torch.models import common
from nmf_tpu_torch.ops import matops
from portbench import readings

SEED = 2**31 + 29


def unchanged(monkeypatch):
    for cls, impl in list(common._IMPLS.items()):
        monkeypatch.setitem(common._IMPLS, cls,
                            impl._replace(update=lambda upd, state, X, W, H: (W, H, state)))
    for cls in list(common._BATCHED):
        monkeypatch.setitem(common._BATCHED, cls, lambda upd, state, X, W, H: (W, H, state))


def half_batch(monkeypatch):
    mm, mtm = readings.halved(matops.mm, matops.mtm)
    monkeypatch.setattr(matops, "mm", mm)
    monkeypatch.setattr(matops, "mtm", mtm)


def altered(monkeypatch):
    nnmf = nt.nnmf

    def wrong(*args, **kw):
        res = nnmf(*args, **kw)
        W = res.W.clone()
        W[W.sum(1).argmax()] *= 2
        return nt.Result(W, res.H, res.niters, res.converged, res.objvalue)

    monkeypatch.setattr(nt, "nnmf", wrong)


@pytest.mark.parametrize("name", cell_names())
@pytest.mark.parametrize("fault", [None, unchanged, half_batch, altered])
def test_fault_is_not_correct(name, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    res = run_tiny(name, SEED, 0.2)
    assert res["attempted"] >= 1
    assert res["correct"] is (fault is None), res["checks"]
