"""Beamforming precoders: MRT, dominant-eigenvector, adaptive update cadence.

Replaces /root/reference/core/beamforming_precoder.py:

- MRT: W = conj(h̄)/‖h̄‖ with h̄ the RX-averaged channel row (lines 41-66)
- eigenbeamforming: dominant eigenvector of HᴴH (lines 68-92), computed on
  via the real 2n×2n symmetric block embedding + jnp.linalg.eigh (complex
  numbers are real pairs here, cplx.C)
- apply_precoding x = W @ s (lines 94-125)
- beamforming gain ‖HW‖²/(‖H‖²_F/num_tx) in dB (lines 173-199)
- adaptive update period from the 90% coherence time T_c = 9/(16π f_D),
  update every 0.1·T_c, clipped to [1, 140] symbols (lines 229-262)
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..config import doppler_hz


def mrt_weights(H: C) -> C:
    """H (..., rx, tx) -> W (..., tx, 1)."""
    h_avg = H.mean(axis=-2)                       # (..., tx)
    w = h_avg.conj()
    norm = jnp.sqrt(w.abs2().sum(axis=-1, keepdims=True))
    w = C(w.re / norm, w.im / norm)
    return C(w.re[..., None], w.im[..., None])


def eigen_weights(H: C) -> C:
    """Dominant eigenvector of HᴴH -> W (..., tx, 1).

    The Hermitian HᴴH embeds as the real symmetric [[Ar,-Ai],[Ai,Ar]]; its
    eigenvalues are each complex eigenvalue doubled and eigenvectors come in
    (xr, xi) pairs — the top one maps back to the complex eigenvector.
    """
    Hh = C(H.re.swapaxes(-1, -2), -H.im.swapaxes(-1, -2))
    A = cplx.matmul_small(Hh, H)                        # (..., n, n) Hermitian
    n = A.shape[-1]
    top = jnp.concatenate([A.re, -A.im], axis=-1)
    bot = jnp.concatenate([A.im, A.re], axis=-1)
    M = jnp.concatenate([top, bot], axis=-2)      # (..., 2n, 2n) symmetric
    _, vecs = jnp.linalg.eigh(M)                  # ascending
    v = vecs[..., -1]                             # (..., 2n) top eigenvector
    w = C(v[..., :n], v[..., n:])
    norm = jnp.sqrt(w.abs2().sum(axis=-1, keepdims=True))
    w = C(w.re / norm, w.im / norm)
    return C(w.re[..., None], w.im[..., None])


def apply_precoding(symbols: C, W: C) -> C:
    """x = W @ s: s (..., L, n) or (..., n) with L=1 -> (..., tx, n)."""
    if symbols.ndim == W.ndim - 1:
        symbols = C(symbols.re[..., None, :], symbols.im[..., None, :])
    return cplx.matmul_small(W, symbols)


def beamforming_gain_db(H: C, W: C) -> jnp.ndarray:
    """10·log10(‖HW‖² / (‖H‖²_F / num_tx))."""
    num_tx = H.shape[-1]
    He = cplx.matmul_small(H, W)
    p_bf = He.abs2().sum(axis=(-2, -1))
    p_no = H.abs2().sum(axis=(-2, -1)) / num_tx
    return 10.0 * jnp.log10(p_bf / p_no)


def update_period_symbols(velocity_kmh: float, frequency_ghz: float = 2.0,
                          delta_f_khz: float = 15.0) -> int:
    """Precoder update cadence in OFDM symbols (beamforming_precoder.py:229-262)."""
    fd = doppler_hz(velocity_kmh, frequency_ghz)
    if fd == 0:
        return 100
    tc = 9.0 / (16.0 * np.pi * fd)
    update_time = 0.1 * tc
    symbol_duration = 1.0 / (delta_f_khz * 1e3)
    return int(np.clip(int(update_time / symbol_duration), 1, 140))
