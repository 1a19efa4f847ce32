"""MIMO channel legs: per-(tx, rx)-link fading + one noise injection per RX.

Batched replacement for the reference's per-link channel objects:

- transmit_mimo (/root/reference/core/ofdm_core.py:434-543):
  * 'awgn' mode: fixed unit taps with 90°/TX phase separation
    h[rx,tx] = exp(i·tx·π/2)  (ofdm_core.py:479-487)
  * 'rayleigh_mp' mode: independent multipath fading per link (no noise),
    summed at each RX (ofdm_core.py:489-520)
  * one AWGN injection per RX with power (P_rx/num_tx)/snr (ofdm_core.py:522-541)

- transmit_spatial_multiplexing (/root/reference/core/channel.py:397-493):
  * flat mode: iid CN(0,1) scalar per link, noise P_rx/snr per RX
  * multipath mode: independent RayleighChannel per link + per-RX noise

- transmit_simo (ofdm_core.py:361-412): one independent SISO channel per RX.

Antennas are array axes; links batch through the Jakes matmul in one shot.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from .awgn import awgn, noise_like
from .rayleigh import (MultipathProfile, apply_multipath, flat_mimo_matrix,
                       rayleigh_multipath)


def _mix_links(H: C, signals_tx: C, num_rx: int) -> C:
    """y[rx] = Σ_tx H[..., rx, tx] · x[tx] as static-loop elementwise FMAs.

    H: (rx, tx) constant or (lanes..., rx, tx); signals_tx: (tx, lanes..., T)
    -> (rx, lanes..., T). An einsum here lowers to batched tiny (rx×tx)
    matmuls; with rx, tx ≤ 8 the unrolled elementwise form fuses into one
    elementwise kernel with no materialized temporaries."""
    num_tx = signals_tx.shape[0]
    per_link_ndim = signals_tx.ndim - 1      # lanes... + T
    ys = []
    for r in range(num_rx):
        acc_re, acc_im = 0.0, 0.0
        for t in range(num_tx):
            hre = H.re[..., r, t]
            him = H.im[..., r, t]
            if jnp.ndim(hre):                # per-lane H: append sample axis
                hre = hre[..., None]
                him = him[..., None]
            xr, xi = signals_tx.re[t], signals_tx.im[t]
            acc_re = acc_re + (hre * xr - him * xi)
            acc_im = acc_im + (hre * xi + him * xr)
        ys.append(C(jnp.broadcast_to(acc_re, signals_tx.shape[1:]),
                    jnp.broadcast_to(acc_im, signals_tx.shape[1:])))
    return cplx.stack(ys, axis=0)


def _per_rx_noise(key, y: C, snr_db, power_scale: float = 1.0) -> C:
    """Add AWGN per RX leg: noise_power = power_scale·P_rx/snr, measured over
    the last axis per leading lane."""
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    p = jnp.mean(y.abs2(), axis=-1, keepdims=True)
    if snr_lin.ndim > 0:
        snr_lin = snr_lin.reshape(snr_lin.shape + (1,) * (p.ndim - snr_lin.ndim))
    noise_power = power_scale * p / snr_lin
    n = noise_like(key, y.shape, noise_power)
    return C(y.re + n.re, y.im + n.im)


def transmit_simo(key, signal: C, snr_db, num_rx: int, channel_type: str,
                  profile: MultipathProfile = None) -> C:
    """One TX signal through num_rx independent channels.

    signal (..., T) -> (num_rx, ..., T).
    """
    keys = jax.random.split(key, num_rx)

    def leg(k):
        if channel_type == "awgn":
            return awgn(k, signal, snr_db,
                        measure_axes=-1 if signal.ndim > 1 else None)
        return rayleigh_multipath(k, signal, snr_db, profile,
                                  measure_axes=-1 if signal.ndim > 1 else None)

    return jax.vmap(leg)(keys)


def mimo_mix_noiseless(key, signals_tx: C, snr_db, num_rx: int,
                       channel_type: str,
                       profile: MultipathProfile = None):
    """transmit_mimo's fading/mixing WITHOUT the noise: returns
    (y (num_rx, ..., T), H, noise_power (num_rx, ...)) with the
    reference's (P_rx/num_tx)/snr noise power (ofdm_core.py:522-541)."""
    num_tx = signals_tx.shape[0]

    if channel_type == "awgn":
        phases = np.exp(1j * np.arange(num_tx) * np.pi / 2)      # (num_tx,)
        H = np.tile(phases[None, :], (num_rx, 1))
        Hc = cplx.const(H)
        y = _mix_links(Hc, signals_tx, num_rx)
    else:
        def one_rx(k):
            ks = jax.random.split(k, num_tx)
            faded = jax.vmap(
                lambda kk, x: apply_multipath(kk, x, profile)
            )(ks, signals_tx)                                     # (num_tx, ..., T)
            return faded.sum(axis=0)                              # (..., T)

        y = jax.vmap(one_rx)(jax.random.split(key, num_rx))
        Hc = cplx.cones((num_rx, num_tx))

    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    p = jnp.mean(y.abs2(), axis=-1)                               # (rx, ...)
    return y, Hc, (p / num_tx) / snr_lin


def transmit_mimo(key, signals_tx: C, snr_db, num_rx: int, channel_type: str,
                  profile: MultipathProfile = None) -> Tuple[C, C]:
    """signals_tx (num_tx, ..., T) -> (y (num_rx, ..., T), H (num_rx, num_tx)).

    H is the fixed AWGN-mode tap matrix (exact) or ones (multipath mode —
    real CSI comes from CRS estimation at the receiver, the reference's
    power-correlation estimate at ofdm_core.py:507-517 is diagnostic only).
    """
    num_tx = signals_tx.shape[0]
    kf, kn = jax.random.split(key)

    if channel_type == "awgn":
        phases = np.exp(1j * np.arange(num_tx) * np.pi / 2)      # (num_tx,)
        H = np.tile(phases[None, :], (num_rx, 1))
        Hc = cplx.const(H)
        # y_rx = Σ_tx h[rx,tx]·x_tx : contract over tx axis (FMAs)
        y = _mix_links(Hc, signals_tx, num_rx)
    else:
        # independent multipath fading per (rx, tx) link, no noise yet
        def one_rx(k):
            ks = jax.random.split(k, num_tx)
            faded = jax.vmap(
                lambda kk, x: apply_multipath(kk, x, profile)
            )(ks, signals_tx)                                     # (num_tx, ..., T)
            return faded.sum(axis=0)                              # (..., T)

        y = jax.vmap(one_rx)(jax.random.split(kf, num_rx))        # (num_rx, ..., T)
        Hc = cplx.cones((num_rx, num_tx))

    keys_n = jax.random.split(kn, num_rx)
    y = jax.vmap(lambda k, yr: _per_rx_noise(k, yr, snr_db, 1.0 / num_tx)
                 )(keys_n, y)
    return y, Hc


def spatial_mix_noiseless(key, signals_tx: C, snr_db, num_rx: int,
                          channel_type: str,
                          profile: MultipathProfile = None):
    """The spatial-multiplexing channel's fading/mixing WITHOUT the noise
    injection: returns (y (num_rx, ..., T), H, noise_power (num_rx, ...)).

    noise_power is the reference's per-RX P_rx/snr measured on the
    post-fading signal (channel.py:458-464) — the caller injects CN noise
    of that variance wherever it observes the signal. The spatial sim adds
    it at the demodulated BINS (unitary-DFT equivalent of time-domain
    noise, same argument and measured BER parity as
    sim/siso._receive_awgn_freq), skipping ~3x the Gaussian volume and the
    rx time-signal rewrite."""
    num_tx = signals_tx.shape[0]
    lanes = signals_tx.shape[1:-1]

    if channel_type == "rayleigh_mp":
        def one_rx(k):
            ks = jax.random.split(k, num_tx)
            faded = jax.vmap(
                lambda kk, x: apply_multipath(kk, x, profile)
            )(ks, signals_tx)
            return faded.sum(axis=0)

        y = jax.vmap(one_rx)(jax.random.split(key, num_rx))
        H = cplx.cones(lanes + (num_rx, num_tx))
    else:
        H = flat_mimo_matrix(key, num_rx, num_tx, lanes)          # (..., rx, tx)
        # y[rx, ..., t] = Σ_tx H[..., rx, tx] · x[tx, ..., t] (FMAs)
        y = _mix_links(H, signals_tx, num_rx)

    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)
    p = jnp.mean(y.abs2(), axis=-1)                               # (rx, ...)
    noise_power = p / snr_lin
    return y, H, noise_power


def transmit_spatial_multiplexing(key, signals_tx: C, snr_db, num_rx: int,
                                  channel_type: str,
                                  profile: MultipathProfile = None
                                  ) -> Tuple[C, C]:
    """TM4 spatial-multiplexing channel (/root/reference/core/channel.py:397-493).

    signals_tx (num_tx, ..., T) -> (y (num_rx, ..., T), H).
    Flat mode: H[..., rx, tx] iid CN(0,1) applied as scalars; multipath mode:
    per-link Jakes multipath, H returned as ones (CRS estimation supplies CSI).
    Noise: P_rx/snr per RX (NOT normalized by num_tx — channel.py:458-464),
    injected in the time domain (the generic path; the spatial sim uses
    spatial_mix_noiseless + bin noise instead).
    """
    kf, kn = jax.random.split(key)
    y, H, noise_power = spatial_mix_noiseless(kf, signals_tx, snr_db,
                                              num_rx, channel_type, profile)
    keys_n = jax.random.split(kn, num_rx)
    y = jax.vmap(lambda k, yr, npw: yr + noise_like(k, yr.shape,
                                                    npw[..., None])
                 )(keys_n, y, noise_power)
    return y, H
