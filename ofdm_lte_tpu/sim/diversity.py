"""Receive/transmit diversity pipelines: SIMO MRC and 2-TX Alamouti SFBC.

Functional, jitted replacements for:
- OFDMSimulator.simulate_simo   (/root/reference/core/ofdm_core.py:1536-1679)
- OFDMSimulator.simulate_miso   (ofdm_core.py:1850-2046)
- OFDMSimulator.simulate_mimo   (ofdm_core.py:2049-2258)

The reference's thread-per-antenna demodulation (ThreadPoolExecutor at
ofdm_core.py:1615-1638) becomes an antenna array axis inside one XLA program
(SURVEY §2.9).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence
from ..ops import qam, ofdm
from ..channel.mimo import transmit_simo, mimo_mix_noiseless
from ..channel import rayleigh
from ..channel.rayleigh import make_profile
from ..rx import estimation as est
from ..rx import alamouti
from ..rx.mimo_estimation import estimate_per_tx
from . import siso as siso_mod


class DiversityResult(NamedTuple):
    bits_rx: jnp.ndarray
    bit_errors: jnp.ndarray
    ber: jnp.ndarray
    papr_db: jnp.ndarray
    symbols_rx: C


def _add_cn(key, x: C, noise_power) -> C:
    """CN(0, noise_power) at the demodulated bins; noise_power (rx, ...)
    aligns against x (rx, ..., S, bins)."""
    npw = noise_power[..., None, None]
    kr, ki = jax.random.split(key)
    std = jnp.sqrt(npw / 2.0)
    return C(x.re + jax.random.normal(kr, x.re.shape, jnp.float32) * std,
             x.im + jax.random.normal(ki, x.im.shape, jnp.float32) * std)


# ---------------------------------------------------------------------------
# SIMO with frequency-domain MRC
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "config", "num_rx", "channel_type", "itu_profile", "velocity_kmh",
    "frequency_ghz"))
def simulate_simo(key: jax.Array, bits: jnp.ndarray, snr_db,
                  config: LTEConfig, num_rx: int = 2,
                  channel_type: str = "awgn",
                  itu_profile: str = "Pedestrian_A",
                  velocity_kmh: float = None,
                  frequency_ghz: float = 2.0) -> DiversityResult:
    """1×N receive diversity: independent channel per RX antenna, per-antenna
    CRS estimation, frequency-domain MRC combining, hard demap."""
    g = grid_for(config)
    profile = None
    if channel_type == "rayleigh_mp":
        profile = make_profile(itu_profile, config.fs, velocity_kmh,
                               frequency_ghz)

    signal_tx = siso_mod.transmit(bits, config)              # (..., T)
    papr = ofdm.papr_db(signal_tx, axis=-1)

    # Default: time-domain noise (unlike sfbc/spatial): the per-leg noise
    # add fuses into the tap-FMA pass, while moving it to the demodulated
    # bins lets the compiler rematerialize the per-leg Jakes fading chain
    # for the extra consumers of the noiseless signal.
    # OFDM_LTE_TPU_SIMO_NOISE=bins selects the bin-domain variant, with an
    # explicit jax.lax.optimization_barrier pinning the faded legs; it has
    # not been timed on the GPU.
    import os
    use_bins = (channel_type == "rayleigh_mp"
                and os.environ.get("OFDM_LTE_TPU_SIMO_NOISE",
                                   "time") == "bins")
    if use_bins:
        kf, kn = jax.random.split(key)
        y = jax.vmap(lambda k: rayleigh.apply_multipath(k, signal_tx,
                                                        profile)
                     )(jax.random.split(kf, num_rx))         # (rx, ..., T)
        yb = jax.lax.optimization_barrier((y.re, y.im))
        y = C(yb[0], yb[1])
        snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
        npow = jnp.mean(y.abs2(), axis=-1) / snr_lin         # (rx, ...)
    else:
        y = transmit_simo(key, signal_tx, snr_db, num_rx, channel_type,
                          profile)
    # y: (num_rx, ..., T)
    yf = ofdm.frame_stream(y, config)                        # (num_rx, ..., S, sps)
    S = yf.shape[-2]

    y_data = ofdm.demodulate_bins(yf, config, g.data_idx)    # (num_rx, ..., S, nd)

    slot_starts = est.slot_start_indices(S)
    y_slot = yf[..., slot_starts, :]
    y_pil = ofdm.demodulate_bins(y_slot, config, g.pilot_idx)
    if use_bins:
        kd, kp = jax.random.split(kn)
        y_data = _add_cn(kd, y_data, npow)
        y_pil = _add_cn(kp, y_pil, npow)
    h_pil = est.ls_at_pilots(y_pil)                          # (num_rx, ..., n_slots, np)
    h_data_slots = est.interpolate(h_pil, config, out_bins=g.data_idx)
    h_data = est.slot_periodic(h_data_slots, S)              # (num_rx, ..., S, nd)

    combined = est.mrc_combine(y_data, h_data, antenna_axis=0)   # (..., S, nd)

    lead = combined.shape[:-2]
    flat = combined.reshape(lead + (S * g.num_data,))
    bits_rx = qam.demodulate(flat, config.modulation).astype(bits.dtype)

    errors = jnp.sum((bits_rx != bits).astype(jnp.int32), axis=-1)
    return DiversityResult(bits_rx, errors, errors / bits.shape[-1], papr,
                           combined)


# ---------------------------------------------------------------------------
# 2-TX Alamouti SFBC (MISO / MIMO)
# ---------------------------------------------------------------------------

def sfbc_data_bins(config: LTEConfig) -> np.ndarray:
    """Data bins for SFBC: even count — drop the last if odd
    (/root/reference/core/sfbc_alamouti.py:196-200)."""
    d = grid_for(config).data_idx
    return d[:len(d) - (len(d) % 2)]


def sfbc_bits_per_frame(config: LTEConfig, num_ofdm_symbols: int) -> int:
    return len(sfbc_data_bins(config)) * config.bits_per_symbol * num_ofdm_symbols


def sfbc_transmit(bits: jnp.ndarray, config: LTEConfig) -> C:
    """bits (..., S·n_even·bps) -> TX signals (2, ..., S·(N+cp)).

    Orthogonal CRS: TX0 on even pilot positions (cell_id 0 sequence), TX1 on
    odd positions (cell_id 1) — sfbc_alamouti.py:241-262.
    """
    g = grid_for(config)
    dbins = sfbc_data_bins(config)
    n_even = len(dbins)
    bps = config.bits_per_symbol
    lead = bits.shape[:-1]
    S = bits.shape[-1] // (n_even * bps)

    syms = qam.modulate(bits, config.modulation).reshape(lead + (S, n_even))
    tx0_syms, tx1_syms = alamouti.encode(syms)

    tx0 = ofdm.modulate_custom(tx0_syms, config, dbins, g.pilot_idx[0::2], 0)
    tx1 = ofdm.modulate_custom(tx1_syms, config, dbins, g.pilot_idx[1::2], 1)
    sig0 = tx0.reshape(lead + (S * config.samples_per_ofdm_symbol,))
    sig1 = tx1.reshape(lead + (S * config.samples_per_ofdm_symbol,))
    return cplx.stack([sig0, sig1], axis=0)


def sfbc_receive(y: C, config: LTEConfig, noise_key=None,
                 noise_power=None):
    """Per-RX SFBC decode with slot-periodic per-TX CRS estimates.

    y: (num_rx, ..., T) -> decoded symbols per RX (num_rx, ..., S, n_even).
    noise_key/noise_power: inject per-RX CN noise at the demodulated bins
    (the sims' bin-domain AWGN path); None = y already carries noise.
    """
    g = grid_for(config)
    dbins = sfbc_data_bins(config)
    yf = ofdm.frame_stream(y, config)
    S = yf.shape[-2]

    y_data = ofdm.demodulate_bins(yf, config, dbins)

    slot_starts = est.slot_start_indices(S)
    y_slot = yf[..., slot_starts, :]
    y_pil = ofdm.demodulate_bins(y_slot, config, g.pilot_idx)
    if noise_key is not None:
        kd, kp = jax.random.split(noise_key)
        y_data = _add_cn(kd, y_data, noise_power)
        y_pil = _add_cn(kp, y_pil, noise_power)
    h_tx = estimate_per_tx(y_pil, config, num_tx=2, out_bins=dbins)
    # (num_rx, ..., n_slots, 2, n_even)
    h_tx = est.slot_periodic(h_tx.reshape(h_tx.shape[:-2] + (-1,)), S)
    h_tx = h_tx.reshape(h_tx.shape[:-1] + (2, len(dbins)))
    h0 = h_tx[..., 0, :]
    h1 = h_tx[..., 1, :]

    return alamouti.decode(y_data, h0, h1)


@functools.partial(jax.jit, static_argnames=(
    "config", "num_rx", "channel_type", "itu_profile", "velocity_kmh",
    "frequency_ghz"))
def simulate_sfbc(key: jax.Array, bits: jnp.ndarray, snr_db,
                  config: LTEConfig, num_rx: int = 1,
                  channel_type: str = "awgn",
                  itu_profile: str = "Pedestrian_A",
                  velocity_kmh: float = None,
                  frequency_ghz: float = 2.0) -> DiversityResult:
    """2×num_rx Alamouti SFBC. num_rx=1 is simulate_miso, num_rx>1 is
    simulate_mimo (per-RX decode then average across RX —
    ofdm_core.py:2204)."""
    profile = None
    if channel_type == "rayleigh_mp":
        profile = make_profile(itu_profile, config.fs, velocity_kmh,
                               frequency_ghz)

    signals_tx = sfbc_transmit(bits, config)                 # (2, ..., T)
    papr = jnp.mean(ofdm.papr_db(signals_tx, axis=-1), axis=0)

    kch, kn = jax.random.split(key)
    y, _H, npow = mimo_mix_noiseless(kch, signals_tx, snr_db, num_rx,
                                     channel_type, profile)  # (num_rx, ..., T)
    decoded_per_rx = sfbc_receive(y, config, noise_key=kn,
                                  noise_power=npow)          # (num_rx, ..., S, ne)
    decoded = decoded_per_rx.mean(axis=0)                    # (..., S, n_even)

    detected = qam.detect(decoded, config.modulation)
    lead = detected.shape[:-2]
    flat = detected.reshape(lead + (-1,))
    bits_rx = qam.demodulate(flat, config.modulation).astype(bits.dtype)

    errors = jnp.sum((bits_rx != bits).astype(jnp.int32), axis=-1)
    return DiversityResult(bits_rx, errors, errors / bits.shape[-1], papr,
                           decoded)


def simulate_miso(key, bits, snr_db, config, **kw) -> DiversityResult:
    """2×1 Alamouti SFBC (ofdm_core.py:1850-2046)."""
    return simulate_sfbc(key, bits, snr_db, config, num_rx=1, **kw)


def simulate_mimo(key, bits, snr_db, config, num_rx: int = 2,
                  **kw) -> DiversityResult:
    """2×N Alamouti SFBC + RX averaging (ofdm_core.py:2049-2258)."""
    return simulate_sfbc(key, bits, snr_db, config, num_rx=num_rx, **kw)
