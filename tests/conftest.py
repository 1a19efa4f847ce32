"""Test configuration: the suite runs on a virtual 8-device CPU mesh.

JAX_PLATFORMS defaults to cpu here, and --xla_force_host_platform_device_count
gives the CPU backend 8 devices, so sharded sweeps are tested without a card.
Tests marked `gpu` need an NVIDIA GPU: they take the `gpu` fixture, which
skips them on any other device. Run them on a card with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`; chip_smoke.py covers the
same paths at full width.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import pytest

# The CLI turns on the persistent compile cache; CPU test compiles are not
# worth keeping, so the suite writes none.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """JAX's first device, if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's first device is "
                    f"{dev.platform}")
    return dev
