"""Global matmul-precision policy for the float32 matmul kernels.

The framework's hot kernels are f32 complex matmuls (DFT modem, Jakes
generator, SC-FDM precoding). On an NVIDIA H100, `default` lets XLA run
float32 dots in TF32 on the tensor cores (10-bit mantissa, unit roundoff
about 4.9e-4); `highest` keeps true float32 arithmetic off the tensor cores;
`high` runs whatever the compiled HLO on the card shows (PERF.md records
it). On the CPU the knob is inert (XLA:CPU dots are plain f32 at every
level), so the CPU test suite's parity results do not depend on it.

Policy is process-level, selected via the environment variable

    OFDM_LTE_TPU_MATMUL_PRECISION = default | high | highest

and read at trace time (flip the env + jax.clear_caches() to change it
mid-process). `default` is the throughput mode; `highest` is the
numerical-parity mode for bit-level agreement with the reference's float64
FFT chain. chip_smoke.py bounds the modem's error against a float64 FFT at
both levels, and compares BER at both levels with the CPU.
"""
from __future__ import annotations

import os

import jax

_LEVELS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def matmul_precision_name() -> str:
    """Current policy name (env re-read each call; jitted programs bake the
    value at first trace — flip the env + jax.clear_caches() to change it
    mid-process)."""
    name = os.environ.get("OFDM_LTE_TPU_MATMUL_PRECISION", "default").lower()
    if name not in _LEVELS:
        raise ValueError(
            f"OFDM_LTE_TPU_MATMUL_PRECISION={name!r}; pick from {list(_LEVELS)}")
    return name


def matmul_precision() -> jax.lax.Precision:
    """Current policy as a jax.lax.Precision."""
    return _LEVELS[matmul_precision_name()]
