import os

# Tests run on the CPU, on a virtual 8-device mesh so multi-device
# sharding paths are exercised without accelerators.  The platform is
# forced through jax.config BEFORE any backend initialization, whatever
# the process's JAX_PLATFORMS says.  What needs the card is a phase of
# chip_smoke.py, not a test.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# persistent compile cache: the coupled-pipeline plugins (TSEQ, ERBTilt)
# have multi-minute first compiles; cache them across test runs.


from zorak_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import pathlib

import pytest

REFERENCE_ROOT = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE_ROOT.exists():
        pytest.skip("reference checkout not available")
    return REFERENCE_ROOT


@pytest.fixture(scope="session")
def reference_plugins(reference_root):
    return reference_root / "plugins"
