"""The plain reference against the port's ``device="cpu"`` path at small
sizes, through the same solve the window makes; the control (the reference
with every product in TF32) against the same limits; the frozen copy of
``nnmf``'s restart draw against the port's own draw."""

import pytest
import torch

from pb_support import cell_names, tiny_cell

from portbench import check, readings
from portbench.reference import common as refc
from portbench.reference.restarts import starts

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", cell_names())
def test_program_within_limits_and_control_outside(name):
    cell = tiny_cell(name)
    out = readings.read_seed(cell, 2**31 + 3, CPU, control=1)[0]
    assert check.passes(check.judged(cell, out["program"])), out
    assert not check.passes(check.judged(cell, out["control"])), out


def test_restart_draw_is_the_ports():
    from nmf_tpu_torch.init.initialization import child_generators, randinit

    seed, p, n, k = 2**33 + 1, 60, 40, 5
    _, grep, _ = child_generators(torch.Generator().manual_seed(seed), 3)
    theirs = [randinit((p, n), k, normalize=True, generator=g, device="cpu")
              for g in child_generators(grep, 4)]
    ours = starts(seed, p, n, k, 4, CPU)
    for (Wt, Ht), (Wo, Ho) in zip(theirs, ours):
        assert torch.equal(Ht, Ho)
        torch.testing.assert_close(Wo, Wt, rtol=2e-7, atol=0)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 2**-12, -(1 + 2**-11), 3.0e-39])
    got = refc.tf32(x)
    assert got.tolist()[:5] == [1.0, 1 + 2**-10, 1 + 2**-10, 1.0, -(1 + 2**-10)]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    assert float(((refc.tf32(y) - y).abs() / y.abs()).max()) <= 2**-11


def test_sparse_operand_products():
    g = torch.Generator().manual_seed(0)
    A = (torch.rand(30, 20, generator=g) < 0.2) * torch.rand(30, 20, generator=g)
    r, c = A.nonzero(as_tuple=True)
    X = refc.Sparse({"shape": (30, 20), "rows": r.int(), "cols": c.int(), "vals": A[r, c]})
    D, E = torch.rand(20, 4, generator=g), torch.rand(30, 4, generator=g)
    exact = refc.Products(False)
    torch.testing.assert_close(X.mm(exact, X.vals, D), A @ D)
    torch.testing.assert_close(X.tmm(exact, X.vals, E), A.T @ E)
    W, H = torch.rand(30, 3, generator=g), torch.rand(3, 20, generator=g)
    torch.testing.assert_close(X.sampled(exact, W, H), (W @ H)[r, c])
    want = 0.5 * float(((A.double() - W.double() @ H.double()) ** 2).sum())
    assert refc.mse(X, W, H) == pytest.approx(want, rel=1e-6)
