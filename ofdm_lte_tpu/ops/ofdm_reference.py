"""Float64 NumPy FFT reference of the OFDM modem, and the error of
ops.ofdm against it.

The reference follows the reference simulator's own chain: grid scatter
(data + CRS pilots, DC/guards null) -> ifft·√N -> CP prepend, and CP strip
-> fft/√N -> bin gather (/root/reference/core/modulator.py:214-250,
lte_receiver.py:444-491).
"""
from __future__ import annotations

import time

import numpy as np
import jax

from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence
from . import ofdm


def modulate_np(data: np.ndarray, config: LTEConfig,
                cell_id: int = 0) -> np.ndarray:
    """(S, n_data) complex data symbols -> (S, N+cp) CP-prefixed samples."""
    g = grid_for(config)
    grid = np.zeros((data.shape[0], config.N), np.complex128)
    grid[:, g.data_idx] = data
    grid[:, g.pilot_idx] = pilot_sequence(cell_id, g.num_pilot)
    t = np.fft.ifft(grid, axis=-1) * np.sqrt(config.N)
    return np.concatenate([t[:, -config.cp_length:], t], axis=-1)


def demodulate_np(y: np.ndarray, config: LTEConfig,
                  bins: np.ndarray) -> np.ndarray:
    """(S, N+cp) samples -> (S, len(bins)) frequency bins."""
    f = np.fft.fft(y[:, config.cp_length:], axis=-1) / np.sqrt(config.N)
    return f[:, bins]


def rel_rms(x: np.ndarray, ref: np.ndarray) -> float:
    """‖x − ref‖ / ‖ref‖ over all entries."""
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _to_c(x: np.ndarray, device) -> C:
    return C(jax.device_put(x.real.astype(np.float32), device),
             jax.device_put(x.imag.astype(np.float32), device))


def _to_np(c: C) -> np.ndarray:
    return np.asarray(c.re, np.float64) + 1j * np.asarray(c.im, np.float64)


def modem_errors(config: LTEConfig, num_symbols: int, seed: int = 0,
                 device=None) -> dict:
    """Relative RMS error of ops.ofdm.modulate_symbols and demodulate_bins
    (on the data bins) against the float64 reference, on unit-power random
    complex data, run on `device` (default: JAX's first device). The
    demodulator's input is the reference waveform rounded to float32, so
    each error measures one direction only. Also returns each jitted step's
    compile seconds and memory analysis. Matmul precision follows
    ofdm_lte_tpu.precision at trace time."""
    device = device or jax.devices()[0]
    g = grid_for(config)
    rng = np.random.default_rng(seed)
    shape = (num_symbols, g.num_data)
    data = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2.0)).astype(np.complex64).astype(np.complex128)
    tx_ref = modulate_np(data, config)
    y = tx_ref.astype(np.complex64).astype(np.complex128)
    rx_ref = demodulate_np(y, config, g.data_idx)

    out = {}
    for name, fn, x, ref in (
            ("modulate", lambda d: ofdm.modulate_symbols(d, config),
             data, tx_ref),
            ("demodulate",
             lambda s: ofdm.demodulate_bins(s, config, g.data_idx),
             y, rx_ref)):
        arg = _to_c(x, device)
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(arg).compile()
        out[name + "_compile_s"] = time.perf_counter() - t0
        out[name + "_memory"] = compiled.memory_analysis()
        out[name] = rel_rms(_to_np(compiled(arg)), ref)
    return out
