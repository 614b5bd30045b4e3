"""Device choice and matmul precision for the PyTorch/CUDA build.

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

__all__ = ["DEFAULT_DEVICE", "resolve_device", "check_on_device"]

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


def check_on_device(dev: torch.device, **tensors) -> None:
    """Raise when a named tensor does not live on ``dev``'s device type."""
    for name, t in tensors.items():
        if t is not None and t.device.type != dev.type:
            raise ValueError(
                f"{name} lives on {t.device} but device={str(dev)!r} was "
                "requested; move it or pass the matching device="
            )
