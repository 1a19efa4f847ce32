"""SC-FDM DFT precoding / decoding as matmuls.

Reference: /root/reference/core/dft_precoding.py — M-point unitary DFT of the
data symbols before grid mapping (W[k,n] = exp(-2πi·k·n/M)/√M, lines 44-54)
and the inverse IDFT at the receiver (lines 133-251). The reference already
implements this as a precomputed M×M matrix multiply; here it is batched over
all OFDM symbols at once and runs as real matmul pairs.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C

from ..precision import matmul_precision


@functools.lru_cache(maxsize=None)
def _dft_consts(M: int, inverse: bool):
    k = np.arange(M, dtype=np.float64)
    sign = 2j if inverse else -2j
    W = np.exp(sign * np.pi * np.outer(k, k) / M) / np.sqrt(M)
    return W.real.astype(np.float32), W.imag.astype(np.float32)


def precode(symbols: C, M: int) -> C:
    """Unitary M-point DFT along the last axis: (..., M) -> (..., M)."""
    Wre, Wim = _dft_consts(M, inverse=False)
    return cplx.matmul(symbols, C(jnp.asarray(Wre), jnp.asarray(Wim)),
                       precision=matmul_precision())


def decode(symbols: C, M: int) -> C:
    """Unitary M-point IDFT along the last axis (receiver side)."""
    Wre, Wim = _dft_consts(M, inverse=True)
    return cplx.matmul(symbols, C(jnp.asarray(Wre), jnp.asarray(Wim)),
                       precision=matmul_precision())
