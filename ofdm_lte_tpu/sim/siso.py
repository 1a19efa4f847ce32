"""SISO OFDM/SC-FDM simulation pipeline — jitted end to end.

Functional, batched replacement for OFDMSimulator.simulate_siso
(/root/reference/core/ofdm_core.py:660-737) and the underlying
OFDMModulator/LTEReceiver call stack (SURVEY §3.1). The whole TX→channel→RX
chain traces into one XLA program; OFDM symbols are a batch axis, not a
Python loop.
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
from ..grid import grid_for
from ..ops import qam, ofdm, scfdm
from ..channel.awgn import awgn
from ..channel.rayleigh import make_profile, rayleigh_multipath, flat_fading
from ..rx import estimation as est


class SisoResult(NamedTuple):
    bits_rx: jnp.ndarray        # (..., n_bits)
    bit_errors: jnp.ndarray     # (...,)
    ber: jnp.ndarray            # (...,)
    papr_db: jnp.ndarray        # (...,)
    pilot_snr_db: jnp.ndarray   # (...,)
    symbols_rx: C               # (..., S, n_data) equalized data symbols
    signal_tx: C                # (..., S·(N+cp))


def bits_per_frame(config: LTEConfig, num_ofdm_symbols: int,
                   mode: str = "lte") -> int:
    n_data = grid_for(config).num_data if mode in ("lte", "sc-fdm") else config.Nc
    return num_ofdm_symbols * n_data * config.bits_per_symbol


def num_symbols_for_bits(config: LTEConfig, n_bits: int, mode: str = "lte") -> int:
    per = bits_per_frame(config, 1, mode)
    return int(np.ceil(n_bits / per))


def transmit(bits: jnp.ndarray, config: LTEConfig, mode: str = "lte",
             cell_id: int = 0) -> C:
    """bits (..., S·n_data·bps) -> CP-prefixed sample stream (..., S·(N+cp)).

    Mirrors OFDMModulator.modulate_stream in 'lte'/'sc-fdm' modes
    (/root/reference/core/modulator.py:214-302) with all symbols batched.
    """
    g = grid_for(config)
    n_data = g.num_data if mode in ("lte", "sc-fdm") else config.Nc
    bps = config.bits_per_symbol
    lead = bits.shape[:-1]
    S = bits.shape[-1] // (n_data * bps)

    syms = qam.modulate(bits, config.modulation)             # (..., S·n_data)
    syms = syms.reshape(lead + (S, n_data))

    if mode == "sc-fdm":
        syms = scfdm.precode(syms, n_data)

    if mode in ("lte", "sc-fdm"):
        tx = ofdm.modulate_symbols(syms, config, cell_id)    # (..., S, N+cp)
    else:
        # 'simple' mode: sequential mapping onto the first Nc bins
        # (/root/reference/core/modulator.py:192-212)
        grid_full = cplx.czeros(lead + (S, config.N))
        grid_full = cplx.scatter_set(
            grid_full, (..., slice(0, config.Nc)), syms)
        tx = ofdm.modulate_grid(grid_full, config)

    return tx.reshape(lead + (S * config.samples_per_ofdm_symbol,))


def receive(signal: C, config: LTEConfig, mode: str = "lte", cell_id: int = 0,
            enable_equalization: bool = True):
    """Sample stream -> (bits, equalized data symbols, pilot SNR dB).

    Implements LTEReceiver.receive_and_decode (lte_receiver.py:235-358):
    frame, per-bin DFT, slot-periodic CRS estimation, per-symbol ZF,
    data-bin gather, optional SC-FDM IDFT, hard detection, bit demap.
    """
    g = grid_for(config)
    y = ofdm.frame_stream(signal, config)                    # (..., S, N+cp)
    S = y.shape[-2]

    if mode == "simple":
        # sequential mapping: first Nc bins, no pilots/equalization
        # (/root/reference/core/demodulator.py:68-118)
        y_bins = ofdm.demodulate_bins(y, config, np.arange(config.Nc))
        lead0 = y_bins.shape[:-2]
        flat0 = y_bins.reshape(lead0 + (S * config.Nc,))
        bits0 = qam.demodulate(flat0, config.modulation)
        zero = jnp.zeros(lead0, jnp.float32)
        return bits0, y_bins, zero

    y_data = ofdm.demodulate_bins(y, config, g.data_idx)     # (..., S, n_data)

    if enable_equalization:
        slot_starts = est.slot_start_indices(S)
        y_slot = y[..., slot_starts, :]                      # (..., n_slots, N+cp)
        y_pil = ofdm.demodulate_bins(y_slot, config, g.pilot_idx)
        return _detect_from_bins(y_data, y_pil, config, mode, cell_id)

    psnr = est.pilot_snr_db(
        ofdm.demodulate_bins(y, config, g.pilot_idx), cell_id, axis=(-2, -1))
    x_eq = y_data
    if mode == "sc-fdm":
        x_eq = scfdm.decode(x_eq, g.num_data)

    lead = x_eq.shape[:-2]
    flat = x_eq.reshape(lead + (S * g.num_data,))
    bits = qam.demodulate(flat, config.modulation)
    return bits, x_eq, psnr


def _detect_from_bins(y_data: C, y_pil: C, config: LTEConfig, mode: str,
                      cell_id: int = 0):
    """Equalized-path back half of receive(): CRS LS estimation from the
    slot-start pilot bins, slot-periodic interpolation, per-symbol ZF,
    optional SC-FDM decode, hard demap. Split out so the frequency-domain
    AWGN path can enter with noise already injected at the bins."""
    g = grid_for(config)
    S = y_data.shape[-2]
    h_pil = est.ls_at_pilots(y_pil, cell_id)                 # (..., n_slots, n_pil)
    psnr = est.pilot_snr_db(y_pil, cell_id, axis=(-2, -1))
    h_data_slots = est.interpolate(h_pil, config, out_bins=g.data_idx)
    h_data = est.slot_periodic(h_data_slots, S)              # (..., S, n_data)
    x_eq = est.zf_equalize(y_data, h_data)

    if mode == "sc-fdm":
        x_eq = scfdm.decode(x_eq, g.num_data)

    lead = x_eq.shape[:-2]
    flat = x_eq.reshape(lead + (S * g.num_data,))
    bits = qam.demodulate(flat, config.modulation)
    return bits, x_eq, psnr


def _receive_awgn_freq(key: jax.Array, signal: C, snr_db, config: LTEConfig,
                       mode: str, measure_axes, cell_id: int = 0):
    """AWGN receive with the noise injected at the demodulated bins.

    The modem's DFT is unitary and the receiver discards the CP samples
    and the guard/DC bins, so time-domain CN(0, σ²) noise reaches the
    detector ONLY as i.i.d. CN(0, σ²) at the S·n_data data bins and the
    n_slots·n_pil slot-start pilot bins. Injecting it there directly is
    statistically identical (BER 0.085850 vs 0.085941 at 2.15M bits,
    64-QAM 15 dB, on the CPU) while generating ~2.1x fewer Gaussians and
    never materializing a separate rx time signal. σ² keeps the reference's
    definition against measured mean TX power (channel.py:10-80)."""
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    p = signal.abs2()
    sig_power = (jnp.mean(p) if measure_axes is None
                 else jnp.mean(p, axis=measure_axes))
    n0 = (sig_power / snr_lin)[..., None, None]              # per-bin var

    g = grid_for(config)
    y = ofdm.frame_stream(signal, config)
    S = y.shape[-2]
    y_data = ofdm.demodulate_bins(y, config, g.data_idx)
    slot_starts = est.slot_start_indices(S)
    y_pil = ofdm.demodulate_bins(y[..., slot_starts, :], config, g.pilot_idx)

    def add_cn(k, x):
        kr, ki = jax.random.split(k)
        std = jnp.sqrt(n0 / 2.0)
        return C(x.re + jax.random.normal(kr, x.re.shape, jnp.float32) * std,
                 x.im + jax.random.normal(ki, x.im.shape, jnp.float32) * std)

    kd, kp = jax.random.split(key)
    return _detect_from_bins(add_cn(kd, y_data), add_cn(kp, y_pil),
                             config, mode, cell_id)


def _apply_channel(key, signal: C, snr_db, channel_type: str,
                   profile, measure_axes) -> C:
    if channel_type == "awgn":
        return awgn(key, signal, snr_db, measure_axes=measure_axes)
    if channel_type == "rayleigh_mp":
        return rayleigh_multipath(key, signal, snr_db, profile,
                                  measure_axes=measure_axes)
    if channel_type == "fading":
        return flat_fading(key, signal, snr_db)
    raise ValueError(f"unknown channel_type {channel_type}")


@functools.partial(jax.jit, static_argnames=(
    "config", "mode", "channel_type", "itu_profile", "velocity_kmh",
    "frequency_ghz", "enable_equalization"))
def simulate_siso(key: jax.Array, bits: jnp.ndarray, snr_db,
                  config: LTEConfig, mode: str = "lte",
                  channel_type: str = "awgn",
                  itu_profile: str = "Pedestrian_A",
                  velocity_kmh: float = None,
                  frequency_ghz: float = 2.0,
                  enable_equalization: bool = True) -> SisoResult:
    """End-to-end SISO Monte-Carlo step.

    bits: (..., n_bits) with n_bits a multiple of bits_per_frame (pad first
    with pad_bits). Leading axes are independent Monte-Carlo lanes; snr_db
    broadcasts against them. Fully jitted: one XLA program.
    """
    profile = None
    if channel_type == "rayleigh_mp":
        profile = make_profile(itu_profile, config.fs, velocity_kmh,
                               frequency_ghz)

    signal_tx = transmit(bits, config, mode)
    papr = ofdm.papr_db(signal_tx, axis=-1)

    measure_axes = -1 if bits.ndim > 1 else None
    if (channel_type == "awgn" and mode in ("lte", "sc-fdm")
            and enable_equalization):
        # AWGN as unitary-DFT-equivalent noise at the received
        # bins (see _receive_awgn_freq) — no rx time signal materialized
        bits_rx, x_eq, psnr = _receive_awgn_freq(
            key, signal_tx, snr_db, config, mode, measure_axes)
    else:
        signal_rx = _apply_channel(key, signal_tx, snr_db, channel_type,
                                   profile, measure_axes)
        bits_rx, x_eq, psnr = receive(
            signal_rx, config, mode, enable_equalization=enable_equalization)

    # follow the caller's bit dtype: with int8 inputs the whole bit-domain
    # HBM traffic (demap write + two compare reads) is 1 B/bit instead of
    # 4 B/bit — XLA fuses the cast into the demapper, so no int32
    # intermediate is materialized (see utils/profiling cost model)
    bits_rx = bits_rx.astype(bits.dtype)
    errors = jnp.sum((bits_rx != bits).astype(jnp.int32), axis=-1)
    ber = errors / bits.shape[-1]
    return SisoResult(bits_rx, errors, ber, papr, psnr, x_eq, signal_tx)


def pad_bits(bits: np.ndarray, config: LTEConfig, mode: str = "lte") -> np.ndarray:
    """Zero-pad a bit array to a whole number of OFDM symbols
    (modulator.py:277-280)."""
    per = bits_per_frame(config, 1, mode)
    S = int(np.ceil(len(bits) / per))
    out = np.zeros(S * per, dtype=np.int32)
    out[:len(bits)] = bits
    return out
