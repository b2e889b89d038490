"""Test harness: run everything on a virtual 8-device CPU mesh so sharding
code paths are exercised without accelerator hardware.  Tests that need a
GPU carry the ``gpu`` marker and ask for the ``gpu_device`` fixture, which
skips them here."""

import os

# The CPU unless JAX_PLATFORMS names other platforms (the on-card run sets
# JAX_PLATFORMS=cuda,cpu; see README, "Testing").  jax.config snapshots the
# variable at import time, so it is also applied through the config below.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from phonic_tpu.compile_cache import use_compile_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)  # float64 oracles in tests

# Persistent compile cache: the suite's wall time is dominated by XLA
# compiles of large render programs; caching them across runs cuts repeat
# suite runs several-fold (fresh checkouts still pay the first run).
use_compile_cache(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache_cpu"), min_compile_secs=0.5)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where there is none.
    Decided here at run time, never at import, so every pytest-xdist worker
    collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda,cpu python -m "
                    "pytest tests/ -m gpu -p no:xdist` on the card")
    return devs[0]
