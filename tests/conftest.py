"""Test configuration: the CPU backend with 8 virtual devices.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default here); the
mesh tests use eight virtual CPU devices. Tests that need the card carry
the `gpu` marker and take the `gpu` fixture, which decides when the test
runs, never at import, whether JAX has a GPU, and skips otherwise. On the
card, `python chip_smoke.py` runs the same checks in one process.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# XLA compiles dominate the suite's runtime; cache even short ones.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import pytest  # noqa: E402

from flan_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX has {dev.platform!r} "
                    "(run `python chip_smoke.py` on the card)")
    return dev
