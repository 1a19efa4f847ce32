"""OFDM modulation/demodulation as fused complex matmuls.

The 128–2048-pt (I)DFTs are expressed as batched matrix multiplies against
precomputed DFT submatrices instead of an FFT call —

- the grid scatter (data bins + pilot bins + DC/guard nulls,
  /root/reference/core/resource_mapper.py:181-223), the IFFT·√N
  (core/modulator.py:242) and the cyclic-prefix prepend (modulator.py:245-248)
  all fuse into ONE complex matmul per direction plus a constant add:

      tx[s, t] = Σ_d  data[s, d] · A[t, d]  +  pilot_wave[t]

  where A = (exp(+2πi·t·k_d/N)/√N) with t running over the CP-extended time
  axis [N-cp .. N-1, 0 .. N-1] and k_d over the *data* bins only (guard/DC
  columns are zero and never materialize). pilot_wave is the constant time-
  domain CRS contribution (the pilot sequence is identical for every OFDM
  symbol in the reference, resource_mapper.py:204-206).

- the receiver computes only the needed frequency bins:
      bins[s, k] = Σ_t  y[s, t] · G[k, t],   G = exp(-2πi·k·t/N)/√N
  replacing CP strip + np.fft.fft/√N (/root/reference/core/lte_receiver.py:484-487).

A complex matmul runs as 4 real f32 matmuls (see cplx.matmul), or 3 in the
Gauss form. Whether an FFT on complex64 beats this dense form on the GPU is
ROADMAP item 1.6; PERF.md holds the card timings. Matmul precision follows
the process-level policy in ofdm_lte_tpu.precision.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence

from ..precision import matmul_precision


def _cmm(a: C, b: C) -> C:
    """Complex matmul for the modem.

    OFDM_LTE_TPU_CMATMUL selects the form: `xla4` (default, the four-product
    expansion of cplx.matmul) or `gauss` (the 3-multiply Gauss/Karatsuba
    form of cplx.matmul_gauss, −25% matmul FLOPs for two operand adds)."""
    import os
    backend = os.environ.get("OFDM_LTE_TPU_CMATMUL", "xla4").lower()
    if backend == "gauss":
        return cplx.matmul_gauss(a, b, precision=matmul_precision())
    if backend != "xla4":
        raise ValueError(
            f"OFDM_LTE_TPU_CMATMUL={backend!r}; pick from ['xla4', 'gauss']")
    return cplx.matmul(a, b, precision=matmul_precision())


@functools.lru_cache(maxsize=None)
def _mod_consts(N: int, Nc: int, cp: int, cell_id: int):
    """(B_re, B_im) of shape (n_data, N+cp) and pilot_wave (N+cp,) complex."""
    g = grid_for_cached(N, Nc)
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])       # (N+cp,)
    k_data = g.data_idx.astype(np.float64)
    A = np.exp(2j * np.pi * np.outer(t, k_data) / N) / np.sqrt(N)  # (N+cp, n_data)

    pilots = pilot_sequence(cell_id, g.num_pilot)
    k_pil = g.pilot_idx.astype(np.float64)
    Ap = np.exp(2j * np.pi * np.outer(t, k_pil) / N) / np.sqrt(N)
    pilot_wave = Ap @ pilots                                        # (N+cp,)

    B = A.T                                                         # (n_data, N+cp)
    return (B.real.astype(np.float32), B.imag.astype(np.float32),
            pilot_wave.real.astype(np.float32),
            pilot_wave.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def grid_for_cached(N: int, Nc: int):
    from ..grid import make_grid
    return make_grid(N, Nc)


@functools.lru_cache(maxsize=None)
def _demod_consts(N: int, cp: int, bins: tuple):
    """(G_re, G_im) of shape (N, n_bins): time -> selected frequency bins."""
    t = np.arange(N)
    k = np.asarray(bins, np.float64)
    G = np.exp(-2j * np.pi * np.outer(t, k) / N) / np.sqrt(N)       # (N, n_bins)
    return G.real.astype(np.float32), G.imag.astype(np.float32)


def modulate_symbols(data: C, config: LTEConfig, cell_id: int = 0) -> C:
    """Map data symbols onto the LTE grid and produce CP-prefixed time signals.

    data: C (..., S, n_data) -> C (..., S, N+cp). One fused complex matmul.
    """
    Bre, Bim, pw_re, pw_im = _mod_consts(config.N, config.Nc,
                                         config.cp_length, cell_id)
    out = _cmm(data, C(jnp.asarray(Bre), jnp.asarray(Bim)))
    return C(out.re + pw_re, out.im + pw_im)


@functools.lru_cache(maxsize=None)
def _mod_consts_custom(N: int, cp: int, data_bins: tuple, pilot_bins: tuple,
                       cell_id: int):
    """Fused-modulation constants for an arbitrary static bin layout.

    Used by the SFBC / spatial-multiplexing TX paths where each antenna maps
    data to a subset of bins and carries its own orthogonal CRS pilots
    (/root/reference/core/sfbc_alamouti.py:241-262,
    core/ofdm_core.py:2642-2654)."""
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    k_data = np.asarray(data_bins, np.float64)
    A = np.exp(2j * np.pi * np.outer(t, k_data) / N) / np.sqrt(N)
    if len(pilot_bins):
        pilots = pilot_sequence(cell_id, len(pilot_bins))
        k_pil = np.asarray(pilot_bins, np.float64)
        Ap = np.exp(2j * np.pi * np.outer(t, k_pil) / N) / np.sqrt(N)
        pw = Ap @ pilots
    else:
        pw = np.zeros(len(t), np.complex128)
    B = A.T
    return (B.real.astype(np.float32), B.imag.astype(np.float32),
            pw.real.astype(np.float32), pw.imag.astype(np.float32))


def modulate_custom(data: C, config: LTEConfig, data_bins, pilot_bins,
                    cell_id: int) -> C:
    """Fused scatter+IDFT+CP for custom data/pilot bin layouts.

    data: C (..., S, len(data_bins)) -> C (..., S, N+cp)."""
    Bre, Bim, pw_re, pw_im = _mod_consts_custom(
        config.N, config.cp_length,
        tuple(int(b) for b in data_bins), tuple(int(b) for b in pilot_bins),
        cell_id)
    out = _cmm(data, C(jnp.asarray(Bre), jnp.asarray(Bim)))
    return C(out.re + pw_re, out.im + pw_im)


@functools.lru_cache(maxsize=None)
def _pilot_wave_const(N: int, cp: int, pilot_bins: tuple, cell_id: int):
    """Constant time-domain CRS contribution for one antenna's pilot layout:
    pw[t] = Σ_j p_j·exp(2πi·t·k_j/N)/√N over the CP-extended time axis."""
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    pilots = pilot_sequence(cell_id, len(pilot_bins))
    Ap = np.exp(2j * np.pi * np.outer(t, np.asarray(pilot_bins, np.float64))
                / N) / np.sqrt(N)
    pw = Ap @ pilots
    return pw.real.astype(np.float32), pw.imag.astype(np.float32)


def modulate_custom_multi(data: C, config: LTEConfig, data_bins,
                          pilot_bins_per_tx, cell_ids) -> C:
    """Fused scatter+IDFT+CP for num_tx antennas sharing ONE data-bin layout
    but carrying per-TX orthogonal CRS (the TM4 spatial TX,
    /root/reference/core/ofdm_core.py:2610-2654): the DFT submatrix depends
    only on the shared data bins, so all antennas run through a single
    batched complex matmul with the antenna axis as a batch dim — no
    per-antenna dispatch, no stack copy — plus a per-TX constant
    pilot-wave add.

    data: C (..., tx, m) with the antenna axis at -2
    -> C (..., tx, N+cp)."""
    num_tx = data.shape[-2]
    Bre, Bim, _, _ = _mod_consts_custom(
        config.N, config.cp_length,
        tuple(int(b) for b in data_bins), (), 0)
    out = _cmm(data, C(jnp.asarray(Bre), jnp.asarray(Bim)))
    pw_re = np.stack([_pilot_wave_const(
        config.N, config.cp_length,
        tuple(int(b) for b in pilot_bins_per_tx[tx]),
        int(cell_ids[tx]))[0] for tx in range(num_tx)])       # (tx, N+cp)
    pw_im = np.stack([_pilot_wave_const(
        config.N, config.cp_length,
        tuple(int(b) for b in pilot_bins_per_tx[tx]),
        int(cell_ids[tx]))[1] for tx in range(num_tx)])
    return C(out.re + pw_re, out.im + pw_im)


def modulate_grid(grid: C, config: LTEConfig) -> C:
    """IFFT·√N + CP for an explicit full N-bin grid (..., S, N) -> (..., S, N+cp).

    Used by the SFBC / spatial-multiplexing TX paths that build custom grids
    (orthogonal pilots per TX antenna)."""
    N, cp = config.N, config.cp_length
    Fre, Fim = _full_idft_consts(N, cp)
    return cplx.matmul(grid, C(jnp.asarray(Fre), jnp.asarray(Fim)),
                       precision=matmul_precision())


@functools.lru_cache(maxsize=None)
def _full_idft_consts(N: int, cp: int):
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    k = np.arange(N, dtype=np.float64)
    A = np.exp(2j * np.pi * np.outer(k, t) / N) / np.sqrt(N)        # (N, N+cp)
    return A.real.astype(np.float32), A.imag.astype(np.float32)


def demodulate_bins(y: C, config: LTEConfig, bins: np.ndarray) -> C:
    """CP strip + DFT/√N restricted to `bins`.

    y: C (..., S, N+cp) time-domain symbols -> C (..., S, len(bins)).
    """
    ysig = y[..., config.cp_length:]
    Gre, Gim = _demod_consts(config.N, config.cp_length,
                             tuple(int(b) for b in bins))
    return _cmm(ysig, C(jnp.asarray(Gre), jnp.asarray(Gim)))


def demodulate_full(y: C, config: LTEConfig) -> C:
    """CP strip + full-N DFT/√N: (..., S, N+cp) -> (..., S, N)."""
    return demodulate_bins(y, config, np.arange(config.N))


def frame_stream(signal: C, config: LTEConfig) -> C:
    """Chunk a flat sample stream (..., S·(N+cp)) into (..., S, N+cp) symbols,
    mirroring /root/reference/core/lte_receiver.py:444-491 (truncates trailing
    partial symbols)."""
    sps = config.samples_per_ofdm_symbol
    S = signal.shape[-1] // sps
    lead = signal.shape[:-1]
    return C(signal.re[..., :S * sps].reshape(lead + (S, sps)),
             signal.im[..., :S * sps].reshape(lead + (S, sps)))


def papr_per_symbol_db(signal: C, config: LTEConfig,
                       include_cp: bool = True) -> jnp.ndarray:
    """Per-OFDM-symbol PAPR, optionally excluding the cyclic prefix
    (reference: OFDMSystem per-symbol + no-CP variants,
    /root/reference/core/ofdm_system.py:80-230).

    signal: (..., S·(N+cp)) -> (..., S)."""
    framed = frame_stream(signal, config)
    if not include_cp:
        framed = framed[..., config.cp_length:]
    return papr_db(framed, axis=-1)


def papr_db(signal: C, axis=None) -> jnp.ndarray:
    """Peak-to-average power ratio in dB
    (/root/reference/core/ofdm_core.py:114-155)."""
    p = signal.abs2()
    peak = jnp.max(p, axis=axis)
    mean = jnp.mean(p, axis=axis)
    return 10.0 * jnp.log10(peak / mean)
