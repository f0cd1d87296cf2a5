"""Test harness configuration.

Tests run on CPU with a virtual 8-device mesh (the fake-backend layer the
reference never needed, SURVEY.md §4) and float64 enabled so device results
can be compared against scalar numpy mirrors at ~1e-12.  Must run before the
first jax import.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# Pin the CPU platform through the config API as well as the environment:
# an installed accelerator plugin may pre-populate jax_platforms.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: re-runs of the suite load serialized CPU
# executables instead of recompiling (also softens the per-module
# clear_caches below — dropped executables reload from disk in ms).
# RT_NO_CACHE=1 opts out.
from raytracing_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables after each test module.

    The full suite accumulates ~1000 XLA:CPU executables in one process;
    past ~250 tests the NEXT backend compile segfaults inside XLA (the
    crash point moves with test order — a cumulative backend state issue,
    not any single test; each module passes alone).  Per-module cache
    clearing keeps the resident executable count bounded; cross-module
    cache reuse is near zero anyway (different programs).
    """
    yield
    jax.clear_caches()
