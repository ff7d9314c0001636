"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so that multi-device sharding paths
compile and execute without a GPU (the environment must be set before jax
initializes a backend).  Tests that need the card carry the `gpu` marker and
skip here (see the `gpu_device` fixture); `python -m pytest -m gpu tests/test_gpu_kernels.py`
on a machine with a GPU keeps JAX's default device and runs them there.
"""

import os

import jax
import pytest

from svim_tpu.config import parse_arguments


def pytest_configure(config):
    if config.option.markexpr == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # also pinned through the config API, which holds even when jax was
    # imported before the environment was set
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def default_options(tmp_path):
    """Options produced by the real argument parser, so defaults are covered
    (mirrors the reference test pattern, tests/test_clustering.py:34)."""
    genome = tmp_path / "genome.fa"
    genome.write_text(">chr1\n" + "A" * 100 + "C" * 100 + "\n")
    return parse_arguments(arguments=[
        "alignment", str(tmp_path), str(tmp_path / "reads.bam"), str(genome)])


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test when JAX finds none (decided here, at
    run time, so every xdist worker collects the same tests)."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (on the card: python -m pytest -m gpu tests/test_gpu_kernels.py)")
    return devices[0]
