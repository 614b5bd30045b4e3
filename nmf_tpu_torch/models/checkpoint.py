"""Checkpoint / resume for long factorization runs.

``solve_checkpointed`` runs a solver's resumable loop (``_solve_while_from``)
in chunks and saves the whole solver state after each: the factors, the
state the solver carries between iterations (ALSPGrad's decaying ``tolg``,
Fast-HALS's shuffle stream) and the iteration counter.  Resuming from a
snapshot continues with the same state, so an interrupted and resumed solve
gives the bits of an uninterrupted ``solve``.

Storage: numpy ``.npz``, one file a process a step,
``ckpt_{step}.proc{rank}.npz``, leaf ``i`` of the flattened tree
``(W, H, state, t)`` stored as ``l{i}_full``.  A file is written under a
temporary name and moved into place with ``os.replace``, so a crash leaves
either the old set of files or the new one.  Nothing is pickled: the tree is
rebuilt from a template, each leaf placed on the template leaf's device with
its dtype.  A ``torch.Generator`` leaf is stored as its ``get_state()``
bytes and restored into a fresh generator.  W and H are stored in the
caller's coordinates whatever coordinates the solve runs in, and a tensor
leaf is the array of the same name the JAX package writes: a directory the
JAX package wrote for a solver whose state holds arrays only loads here as
it is.

The rank and the number of processes come from ``torch.distributed`` when
it is initialized (0 and 1 otherwise); every process writes its own files.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .. import config
from ..utils import spans
from .common import (
    Result,
    _impl_for,
    _renumber_ok,
    _solve_while_from,
    nmf_checksize,
    renumbered_problem,
    unrenumber,
)

__all__ = [
    "solve_checkpointed",
    "save_state",
    "load_state",
    "latest_checkpoint",
    "agreed_checkpoint",
]

_STEP_RE = re.compile(r"ckpt_(\d+)\.proc(\d+)\.npz$")
_AGREE_PAD = 128  # most steps a process offers in the agreement


def _dist():
    """``torch.distributed`` when a process group is initialized, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _leaves(tree) -> list:
    """The leaves of a tree of tuples, in order."""
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    if not isinstance(tree, (torch.Tensor, torch.Generator)):
        raise TypeError(
            f"a snapshot holds tuples of tensors and generators, not {type(tree).__name__}")
    return [tree]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(template, tuple):
        return tuple(_rebuild(sub, leaves) for sub in template)
    return next(leaves)


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    return leaf.detach().cpu().numpy()


def _leaf_like(arr: np.ndarray, t, path: str, i: int):
    """Leaf ``i`` read from ``path`` as the template leaf ``t`` is: on its
    device with its dtype."""
    if isinstance(t, torch.Generator):
        want = t.get_state()
        if arr.dtype != np.uint8 or arr.shape != tuple(want.shape):
            raise ValueError(
                f"Checkpoint {path}: leaf {i} is {arr.dtype}{list(arr.shape)}, "
                f"where a torch.Generator's state (uint8[{want.numel()}]) is "
                "expected; a Fast-HALS checkpoint of the JAX package holds a "
                "random key there, which no torch.Generator can resume")
        gen = torch.Generator(device=t.device)
        return gen.set_state(torch.from_numpy(arr.copy()))
    if arr.shape != tuple(t.shape):
        raise ValueError(
            f"Checkpoint {path}: leaf {i} has shape {list(arr.shape)}, the "
            f"template's {list(t.shape)}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=t.device, dtype=t.dtype)


def save_state(directory: str, step: int, tree) -> str:
    """Save this process's snapshot of ``tree`` (nested tuples of tensors
    and generators) for iteration ``step``; with several processes every one
    of them calls this."""
    os.makedirs(directory, exist_ok=True)
    payload = {f"l{i}_full": _as_array(leaf) for i, leaf in enumerate(_leaves(tree))}
    path = os.path.join(directory, f"ckpt_{step}.proc{_rank()}.npz")
    tmp = path + ".tmp.npz"  # the .npz suffix stops np.savez adding one
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def load_state(path: str, template):
    """Load one snapshot file, shaped like ``template``: each leaf on the
    template leaf's device with its dtype (a generator leaf restored into a
    fresh generator)."""
    with np.load(path) as data:
        files = set(data.files)
        out = []
        for i, t in enumerate(_leaves(template)):
            if f"l{i}_full" not in files:
                extra = " (it holds shards of a distributed array)" if (
                    f"l{i}_s0_data" in files) else ""
                raise ValueError(f"Checkpoint {path} is missing leaf {i}{extra}.")
            out.append(_leaf_like(data[f"l{i}_full"], t, path, i))
    return _rebuild(template, iter(out))


def _own_files(directory: str) -> list[tuple[int, str]]:
    """(step, file name) of THIS process's files, by step."""
    if not os.path.isdir(directory):
        return []
    rank = _rank()
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and int(m.group(2)) == rank:
            out.append((int(m.group(1)), name))
    return sorted(out)


def _local_steps(directory: str) -> list[int]:
    """Sorted steps of THIS process's files."""
    return [step for step, _ in _own_files(directory)]


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.proc{_rank()}.npz")


def latest_checkpoint(directory: str) -> tuple[str, int] | None:
    """Latest (path, step) of THIS process's files."""
    steps = _local_steps(directory)
    if not steps:
        return None
    return _path(directory, steps[-1]), steps[-1]


def _common_latest(steps_by_process: list[list[int]]) -> int | None:
    """Largest step present on EVERY process (None if there is none)."""
    sets = [set(s) for s in steps_by_process]
    common = set.intersection(*sets) if sets else set()
    return max(common) if common else None


def agreed_checkpoint(directory: str) -> tuple[str, int] | None:
    """The resume point every process can take: the largest step present on
    all of them.  A crash between two processes' saves leaves them with
    different latest steps, and resuming each from its own would set their
    solves apart.  With one process this is ``latest_checkpoint``; with
    several, each offers its newest ``_AGREE_PAD`` steps through
    ``all_gather``."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return latest_checkpoint(directory)
    steps = _local_steps(directory)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    vec = torch.full((_AGREE_PAD,), -1, dtype=torch.int64)
    mine = steps[-_AGREE_PAD:]
    vec[: len(mine)] = torch.tensor(mine, dtype=torch.int64)
    vec = vec.to(dev)
    rows = [torch.empty_like(vec) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, vec)
    step = _common_latest([[s for s in row.tolist() if s >= 0] for row in rows])
    if step is None:
        return None
    return _path(directory, step), step


@config.precision_scope()
def solve_checkpointed(alg, X, W, H, *, checkpoint_dir: str,
                       checkpoint_every: int = 10, keep: int = 3,
                       device=config.DEFAULT_DEVICE) -> Result:
    """Solve with a snapshot every ``checkpoint_every`` iterations, resuming
    from the newest snapshot in ``checkpoint_dir`` that every process holds.
    The Result is the one an uninterrupted ``solve(alg, X, W, H)`` returns,
    bit for bit: the same loop runs in the same coordinates (a degree-ordered
    store's renumbered ones, as ``solve``), from the same state.  The
    objective is computed once, on the final factors.  Resuming drops the
    snapshots past the resume point; the newest ``keep`` steps are kept.
    ``X``, ``W`` and ``H`` must live on ``device``."""
    from ..ops import matops

    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be at least 1")
    dev = config.resolve_device(device)
    X = matops.as_operand(X)
    config.check_on_device(dev, X=matops.device_probe(X), W=W, H=H)
    X = matops.contiguous(X)
    nmf_checksize(X, W, H)
    upd, tol = alg._resolved(W.dtype)
    impl = _impl_for(upd)
    maxiter = int(upd.maxiter)

    perms = None
    if _renumber_ok(upd, X):
        X, W, H, perms = renumbered_problem(X, W, H)

    def callers(W, H):
        """The factors in the caller's coordinates."""
        return (W, H) if perms is None else unrenumber(W, H, perms)

    state = impl.prepare(upd, X, W, H)
    t = 0
    resume = agreed_checkpoint(checkpoint_dir)
    if resume is not None:
        template = (W, H, state, torch.zeros((), dtype=torch.int32))
        W, H, state, t_saved = load_state(resume[0], template)
        t = int(t_saved)
        if perms is not None:
            W = W.index_select(0, perms[0].long())
            H = H.index_select(1, perms[2].long())
        # later steps some process may hold from a partial save would
        # poison a later agreement
        _prune_above(checkpoint_dir, t)

    converged = False
    while t < maxiter and not converged:
        end = min(t + checkpoint_every, maxiter)
        W, H, state, t, converged, _ = _solve_while_from(
            upd, state, X, W, H, t, end, tol, with_objective=False)
        save_state(checkpoint_dir, t,
                   (*callers(W, H), state, torch.tensor(t, dtype=torch.int32)))
        _prune(checkpoint_dir, keep)

    objv = spans.host_read(impl.objective(upd, state, X, W, H), "float")
    return Result(*callers(W, H), t, converged, objv)


def _remove(directory: str, name: str) -> None:
    try:
        os.remove(os.path.join(directory, name))
    except OSError:
        pass


def _prune(directory: str, keep: int):
    """Keep the newest ``keep`` steps of THIS process's files.  With several
    processes keep at least 2: they save one chunk apart at most across a
    crash, so the previous step is what they still share."""
    for _, name in (_own_files(directory)[:-keep] if keep > 0 else []):
        _remove(directory, name)


def _prune_above(directory: str, step: int):
    """Remove THIS process's files of steps after ``step``."""
    for s, name in _own_files(directory):
        if s > step:
            _remove(directory, name)
