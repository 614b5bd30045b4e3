"""Small helpers shared by the harness, the generators and the reference.
Nothing here imports the program."""

from __future__ import annotations

import contextlib
import zlib

import numpy as np
import torch

# one H100 SXM (NVIDIA's data sheet, dense rates): HBM3 bandwidth, and the
# rate of work that keeps float32's precision: TF32's 495 TFLOP/s over the
# three products of a 3xTF32 split.  No float32-exact implementation, on the
# CUDA cores (67 TFLOP/s) or on the tensor cores, can beat either.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 495e12 / 3


def mix(seed: int, *parts) -> int:
    """A 63-bit seed for one stream, from the run's seed and the stream's
    name or index: the same arguments give the same seed on every machine."""
    words = [int(seed) % 2**64]
    for part in parts:
        words.append(zlib.crc32(part.encode()) if isinstance(part, str) else int(part) % 2**64)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *parts))


@contextlib.contextmanager
def ieee_matmul():
    """Float32 products in full float32 (no TF32) inside the block; the
    caller's settings come back after it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = saved


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
