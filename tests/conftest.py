"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the JAX-native "multi-chip without a real cluster" mechanism
(SURVEY.md §4): correctness tests run in f64 on CPU, and the sharding tests
see 8 devices via --xla_force_host_platform_device_count.  Unless
``JAX_PLATFORMS`` names the platforms, the CPU is pinned through
``jax.config``, so a machine with a GPU still runs this suite on the CPU.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` (see README).
"""

import os
import sys

# The repository root, for the root-level scripts the tests import
# (``chip_smoke``).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pytest  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import nllstpu  # noqa: E402,F401  (enables x64)
from nllstpu.utils.compile_cache import configure_compile_cache  # noqa: E402

# Persistent compilation cache: the 8-device shard_map programs in
# tests/test_parallel.py take ~30s each to compile cold; cached reruns
# roughly halve that file's runtime (tracing is not cached).
configure_compile_cache(min_compile_time_secs=2.0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when JAX finds none"
    )


@pytest.fixture
def gpu():
    """The first GPU device, or skip: decided when the test runs, never at
    import or collection, so every worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
    return devs[0]
