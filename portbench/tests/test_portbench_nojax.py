"""The check that no JAX module was loaded compares whole top-level names."""

import subprocess
import sys

from pb_support import ROOT

from portbench import nojax


def test_the_port_passes():
    assert nojax.loaded(["nmf_tpu_torch", "nmf_tpu_torch.ops.matops", "torch", "numpy",
                         "jaxtyping", "flaxen"]) == []


def test_jax_and_the_jax_package_are_found():
    found = nojax.loaded(["nmf_tpu", "nmf_tpu.models.common", "jax", "jax.numpy", "jaxlib",
                          "flax.linen", "torch"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib", "nmf_tpu",
                     "nmf_tpu.models.common"]


def test_the_harness_and_the_port_load_no_jax():
    """In a fresh process, as a run has them loaded."""
    code = ("import sys; sys.path.insert(0, %r); import nmf_tpu_torch; "
            "from portbench import check, harness, profile, readings, roofline; "
            "from portbench.nojax import loaded; print(loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"
