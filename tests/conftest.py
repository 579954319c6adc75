"""Test configuration: force an 8-device virtual CPU mesh.

SURVEY.md §4: the reference has no test suite; our strategy is unit tests
for ops/models vs. naive numerics, multi-device sharding tests on a virtual
host-platform mesh, and serving tests with a sleep-based fake engine (the
reference's own accel-simulator pattern, accelInferenceEngine.py:58-64).

The CPU is selected explicitly (``jax_platforms="cpu"``), which is what
lets ``utils/devices.pick_accel_device`` hand the engines a CPU device
here. XLA_FLAGS is read at first backend init, which happens later.
Tests that need a GPU carry the ``gpu`` marker and decide inside the test
whether one is present.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _restore_compilation_cache_dir():
    """CLI entry points enable the persistent compile cache; keep that
    setting from leaking into the next test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)
