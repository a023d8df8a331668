"""Test config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated on virtual CPU devices
(xla_force_host_platform_device_count).  Tests marked ``gpu`` need the
card: they take the ``gpu_devices`` fixture, which skips them here, and
run on a GPU machine with ``JAX_PLATFORMS= pytest -m gpu``.
"""
import os
import sys

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.dont_write_bytecode = True

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)


@pytest.fixture
def gpu_devices():
    """The GPU devices; skips the test where JAX has none."""
    from pymht_tpu.utils.runtime import require_gpu
    try:
        return require_gpu()
    except RuntimeError as e:
        pytest.skip(str(e))
