"""Batched random restarts: the restarts of ``solve_replicates`` run as
lanes of one solve.

The JAX package ``vmap``s its whole jitted solve over the restarts, and
``lax.while_loop`` batching masks each lane once it has converged.  Here the
lanes share a Python loop: one iteration steps every lane still running,
runs ``stop_condition`` on each lane, and reads all the lanes' flags back to
the host at once; a lane that has converged (or reached ``maxiter``) leaves
the batch with its factors, iteration count and flag, so every lane reports
what its own sequential solve would.

Where a solver registered a width-batched updater (``register_batched``:
Fast-HALS and GreedyCD), the running lanes step together: X enters through
one product of width ``m * k`` a half-step, and their column steps, or
GreedyCD's masked steps, run as one batch, so the host enqueues a step once
for all lanes.  Every other solver steps its lanes one after the other with
its own ``update`` (the sequential bits), and still reads all the lanes'
flags once an iteration.

While ``utils.spans`` records, ``solve_lanes`` is a ``solve`` span (attr
``lanes``) whose ``iter`` spans carry ``lanes``, the lanes still running;
``solve_replicates_batched`` draws the starts in ``replicates.draw`` and
steps them in ``replicates.lanes``.
"""

from __future__ import annotations

import torch

from .. import config
from ..init.initialization import child_generators, randinit
from ..ops import matops
from ..utils import spans
from .common import (
    _BATCHED,
    Result,
    _impl_for,
    _renumber_ok,
    nmf_checksize,
    renumbered_problem,
    stop_condition,
    unrenumber,
)

__all__ = ["solve_lanes", "solve_replicates_batched"]


@config.precision_scope()
def solve_lanes(alginst, X, Ws, Hs, *, device=config.DEFAULT_DEVICE):
    """Solve from r stacked starts, ``Ws`` ``(r, p, k)`` and ``Hs``
    ``(r, k, n)``, in lockstep.  Returns one ``(W, H, niters, converged,
    objvalue)`` a lane, each what ``solve(alginst, X, Ws[i], Hs[i])``
    reports: a lane stops at its own convergence, and its objective is the
    solver's objective on its final factors.  ``X``, ``Ws`` and ``Hs`` must
    live on ``device``; a degree-ordered store is renumbered once for all
    the lanes, as ``solve`` renumbers it for one."""
    dev = config.resolve_device(device)
    X = matops.contiguous(matops.as_operand(X))
    config.check_on_device(dev, X=matops.device_probe(X), Ws=Ws, Hs=Hs)
    r = Ws.shape[0]
    if Hs.shape[0] != r:
        raise ValueError(f"{r} starts of W but {Hs.shape[0]} of H")
    nmf_checksize(X, Ws[0], Hs[0])
    upd, tol = alginst._resolved(Ws.dtype)
    with spans.span("solve", alg=type(upd).__name__, lanes=r):
        impl = _impl_for(upd)
        batched = _BATCHED.get(type(upd))
        perms = None
        if _renumber_ok(upd, X):
            with spans.span("solve.renumber"):
                X, Ws, Hs, perms = renumbered_problem(X, Ws, Hs)
        else:
            Ws, Hs = Ws.contiguous(), Hs.contiguous()

        maxiter = int(upd.maxiter)
        # the lanes as a stacked pair for a batched updater, else one tensor a
        # lane, each as the sequential solve holds it
        with spans.span("solve.prepare"):
            if batched is not None:
                state = impl.prepare(upd, X, Ws[0], Hs[0])
                W, H = Ws, Hs
            else:
                W, H = list(Ws.unbind(0)), list(Hs.unbind(0))
                state = [impl.prepare(upd, X, w, h) for w, h in zip(W, H)]
        running = list(range(r))  # lane of each slot of the batch
        final = [None] * r  # (W, H, niters, converged, state) once a lane stops
        t = 0
        while running and t < maxiter:
            with spans.span("iter", t=t, lanes=len(running)):
                if batched is not None:
                    Wn, Hn, state = batched(upd, state, X, W, H)
                else:
                    stepped = [impl.update(upd, s, X, w, h) for s, w, h in zip(state, W, H)]
                    Wn, Hn, state = (list(a) for a in zip(*stepped))
                with spans.span("stop"):
                    conv = torch.stack([stop_condition(Wn[i], W[i], Hn[i], H[i], tol)[0]
                                        for i in range(len(running))])
                    # the one host sync of the iteration
                    flags = spans.host_read(conv, "tolist")
                t += 1
                W, H = Wn, Hn
                stay = [i for i, f in enumerate(flags) if not f and t < maxiter]
                for i, f in enumerate(flags):
                    if f or t >= maxiter:
                        lane_state = state if batched is not None else state[i]
                        final[running[i]] = (W[i], H[i], t, f, lane_state)
                if len(stay) < len(running):
                    running = [running[i] for i in stay]
                    if batched is not None:
                        at = torch.tensor(stay, dtype=torch.long, device=W.device)
                        W, H = W.index_select(0, at), H.index_select(0, at)
                    else:
                        W, H, state = ([a[i] for i in stay] for a in (W, H, state))
        for i, lane in enumerate(running):  # maxiter of 0
            final[lane] = (W[i], H[i], t, False,
                           state if batched is not None else state[i])

        out = []
        for w, h, niters, converged, s in final:
            with spans.span("solve.objective"):
                objv = impl.objective(upd, s, X, w, h)
            if perms is not None:
                with spans.span("solve.unrenumber"):
                    w, h = unrenumber(w, h, perms)
            out.append((w, h, niters, converged, objv))
        return out


def solve_replicates_batched(alginst, X, k: int, nrep: int, *, initH: bool,
                             generator, device=config.DEFAULT_DEVICE, mesh=None):
    """Run ``nrep`` random restarts as the lanes of one ``solve_lanes`` and
    return the best as a ``Result`` (the first lane of the least objective,
    as the sequential loop picks), or None for a solver with no iterative
    path (SPA).  The starts are the sequential loop's:
    ``child_generators(generator, nrep)``, each drawn by ``randinit(...,
    normalize=True)``; with ``mesh`` they go to ``mesh.lead``."""
    if nrep < 1 or not hasattr(alginst, "_resolved"):
        return None
    dev = mesh.lead if mesh is not None else config.resolve_device(device)
    with spans.span("replicates.draw"):
        starts = [randinit(X, k, zeroh=not initH, normalize=True, generator=sub,
                           device=dev) for sub in child_generators(generator, nrep)]
        Ws = torch.stack([w for w, _ in starts])
        Hs = torch.stack([h for _, h in starts])
        del starts
    with spans.span("replicates.lanes"):
        lanes = solve_lanes(alginst, X, Ws, Hs, device=dev)
    results = [Result(*lane) for lane in lanes]
    best = results[0]
    for res in results[1:]:  # as the sequential loop keeps its best
        if best.objvalue > res.objvalue:
            best = res
    return best
