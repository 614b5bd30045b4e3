"""Device choice, matmul precision and the GreedyCD cascade schedule for the
PyTorch/CUDA build.

The build targets one NVIDIA Hopper card.  Every entry point takes an
explicit ``device=`` whose default is ``"cuda"``; when no card is present the
entry point raises instead of silently carrying on on the CPU (a CPU run says
nothing about the card).  Callers that want the CPU — the parity tests — say
``device="cpu"``.

Float32 products run in full float32: TF32 is switched off here and the
hand-written kernels use FMA on the CUDA cores.  Any faster precision would
be opt-in and has to be measured on the card first.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "same_device", "check_on_device",
           "greedycd_cascade", "set_greedycd_cascade"]

# exact fp32: stated and set (PyTorch's own default for matmul is already
# False; cuDNN's is True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


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


def set_greedycd_cascade(shrink: int | None = None, min: int | None = None,
                         off_rows: int | None = None,
                         slab_rows: int | None = None) -> None:
    """Override the GreedyCD cascade schedule (None = keep current).  The
    schedule changes how the rows are batched, never a row's result."""
    new = dict(shrink=shrink, min=min, off_rows=off_rows, slab_rows=slab_rows)
    for key, val in new.items():
        lo = 2 if key == "shrink" else 1
        if val is not None and (
            isinstance(val, bool) or not isinstance(val, int) or val < lo
        ):
            raise ValueError(f"cascade {key} must be an int >= {lo}")
    greedycd_cascade.update({k: v for k, v in new.items() if v is not None})
