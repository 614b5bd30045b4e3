"""Device choice, matmul precision and the GreedyCD and FNNLS cascade
schedules for the PyTorch/CUDA build.

The build targets one NVIDIA Hopper card.  Every entry point takes an
explicit ``device=`` whose default is ``"cuda"``; when no card is present the
entry point raises instead of silently carrying on on the CPU (a CPU run says
nothing about the card).  Callers that want the CPU — the parity tests — say
``device="cpu"``.

Float32 products run in full float32: every public entry point that
computes runs inside ``precision_scope``, which holds cuBLAS at IEEE float32
for the call and gives the caller's setting back after it; the hand-written
kernels use FMA on the CUDA cores and read no flag.  Importing the package
changes no torch setting.  Any faster precision would be opt-in and has to
be measured on the card first.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "same_device", "check_on_device",
           "precision_scope", "greedycd_cascade", "set_greedycd_cascade",
           "fnnls_cascade", "set_fnnls_cascade"]

DEFAULT_DEVICE = "cuda"


@contextlib.contextmanager
def precision_scope():
    """Hold cuBLAS's float32 matmul precision at ``"ieee"`` (no TF32) inside
    the ``with`` block and give back the caller's value on the way out,
    also when the block raises.  It reads and writes through torch's new
    API only (``torch.backends.cuda.matmul.fp32_precision``), so a caller
    who set the legacy ``torch.set_float32_matmul_precision("high")`` reads
    ``"high"`` from ``torch.get_float32_matmul_precision()`` afterwards.
    cuDNN's setting is not touched: the port runs no convolution.  Scopes
    nest; ``@precision_scope()`` runs a function inside one."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = saved


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when a CUDA device
    is asked for (the default) and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` are one device: ``cuda`` without an index is
    the current CUDA device."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    ia, ib = (torch.cuda.current_device() if d.index is None else d.index
              for d in (a, b))
    return ia == ib


def check_on_device(dev: torch.device, **tensors) -> None:
    """Raise when a named tensor does not live on ``dev``."""
    for name, t in tensors.items():
        if t is not None and not same_device(t.device, dev):
            raise ValueError(
                f"{name} lives on {t.device} but device={str(dev)!r} was "
                "requested; move it or pass the matching device="
            )


# GreedyCD's compaction cascade (``models/greedycd.py``): masked steps run
# over a buffer of rows until the rows still active fit a buffer ``shrink``
# times smaller, then those rows are gathered and the loop goes on there,
# down to buffers of ``min`` rows.  Below ``off_rows`` rows nothing is
# compacted; above ``slab_rows`` rows a half-step runs slab by slab (its
# scratch is four (rows, k) arrays).  Read at call time; change them through
# ``set_greedycd_cascade``.
greedycd_cascade: dict[str, int] = {
    "shrink": 4,
    "min": 128,
    "off_rows": 4096,
    "slab_rows": 524_288,
}


def _set_cascade(knobs: dict, new: dict) -> None:
    """Validate every given value (``shrink`` an int >= 2, the rest ints
    >= 1), then write them into ``knobs``; None keeps the current value."""
    for key, val in new.items():
        lo = 2 if key == "shrink" else 1
        if val is not None and (
            isinstance(val, bool) or not isinstance(val, int) or val < lo
        ):
            raise ValueError(f"cascade {key} must be an int >= {lo}")
    knobs.update({k: v for k, v in new.items() if v is not None})


def set_greedycd_cascade(shrink: int | None = None, min: int | None = None,
                         off_rows: int | None = None,
                         slab_rows: int | None = None) -> None:
    """Override the GreedyCD cascade schedule (None = keep current).  The
    schedule changes how the rows are batched, never a row's result."""
    _set_cascade(greedycd_cascade, dict(shrink=shrink, min=min,
                                        off_rows=off_rows, slab_rows=slab_rows))


# FNNLS's compaction cascade (``ops/fnnls.py``): the same machinery over the
# right-hand-side columns of the batched solve.  Below ``off_cols`` columns
# one buffer of all of them runs uncompacted.  Read at call time; change
# them through ``set_fnnls_cascade``.
fnnls_cascade: dict[str, int] = {
    "shrink": 4,
    "min": 256,
    "off_cols": 2048,
}


def set_fnnls_cascade(shrink: int | None = None, min: int | None = None,
                      off_cols: int | None = None) -> None:
    """Override the FNNLS cascade schedule (None = keep current).  The
    schedule changes how the columns are batched, never a column's result."""
    _set_cascade(fnnls_cascade, dict(shrink=shrink, min=min, off_cols=off_cols))
