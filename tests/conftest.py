"""Test configuration: run everything on a virtual 8-device CPU mesh with
fp64 enabled, so sharding/collective paths are exercised without an
accelerator and numerics match the reference's double-precision MEX
solvers.

Must set env vars before jax is imported anywhere in the test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

# Hermetic auto-backend probe cache: the on-disk cache (api._auto_backend)
# must not leak probe decisions between test sessions
# or into the user's real cache.
import tempfile  # noqa: E402

os.environ["SPCIES_AUTO_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="spcies_auto_cache_test_")


import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked `gpu` run only on a card
    (the choice is made here, at run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev
