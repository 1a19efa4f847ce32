"""Run-time setup shared by the entry points (chip_smoke.py, bench.py and
the CLI): the persistent compile cache, the GPU check and the card's
name and power limit."""
from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory and
    return it. A JAX_COMPILATION_CACHE_DIR set in the environment is left
    to JAX; otherwise the cache is `<checkout>/.jax_cache`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first JAX device; exits nonzero unless it is a GPU, so no
    measurement falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's first device is "
                         f"{dev.platform} ({dev.device_kind})")
    return dev


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them, read by
    a child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
