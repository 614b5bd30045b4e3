"""The check that no JAX was loaded: the process that prints the result may
hold no module whose top-level name (before the first dot, compared whole)
is one of ``FORBIDDEN``.  ``nmf_tpu_torch`` begins with ``nmf_tpu`` and
passes."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nmf_tpu")


def loaded(modules=None) -> list:
    """The forbidden modules among ``modules`` (``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
