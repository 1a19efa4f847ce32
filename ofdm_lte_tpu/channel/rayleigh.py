"""Rayleigh fading channels: Jakes sum-of-sinusoids + ITU multipath FIR.

Batched reformulation of /root/reference/core/rayleighchannel.py and
core/channel.py:83-245:

- Jakes fading h(t) = √(2/Ns)·Σ_n exp(j(2π f_D cos(α_n) t + φ_n)) with
  Ns=16 sinusoids, α_n = 2πn/Ns, φ_n ~ U(0,2π)
  (rayleighchannel.py:20-42). Vectorized as ONE complex matmul:
      H(T, L) = E(T, Ns) @ P(Ns, L)
  where E = exp(j ω_n t) is shared across all links/taps (depends only on
  f_D and the sample clock) and P = exp(j φ) carries the per-(tap, link)
  random phases. The reference regenerates an independent waveform per tap
  per call (rayleighchannel.py:51-53); here taps × links × frames fold into
  the L axis of the matmul.

- Multipath: y(t) = Σ_i g_i · h_i(t) · x(t - d_i) with integer-sample static
  delays d_i = round(delay·fs) and linear amplitudes g_i = 10^(dB/20)
  (rayleighchannel.py:44-58, channel.py:162-186). Delays are static shifts
  (pad + slice), so the tap loop unrolls into the XLA graph.

- SNR is applied against the measured *post-fading* power
  (channel.py:216-229), matching the reference's definition.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..config import ITU_CHANNEL_MODELS, ITU_DEFAULT_VELOCITY_KMH, doppler_hz
from .awgn import awgn

from ..precision import matmul_precision
N_SINUSOIDS = 16


class MultipathProfile(NamedTuple):
    """Static channel profile: integer delays (samples), linear tap gains."""

    name: str
    delays_samples: tuple      # ints
    gains_linear: tuple        # floats (amplitude, 10^(dB/20))
    doppler_hz: float
    fs: float

    @property
    def num_taps(self) -> int:
        return len(self.delays_samples)


@functools.lru_cache(maxsize=None)
def make_profile(itu_profile: str, fs: float, velocity_kmh: float = None,
                 frequency_ghz: float = 2.0, fd: float = None,
                 gain_convention: str = "reference") -> MultipathProfile:
    """Build a static multipath profile.

    gain_convention:
    - "reference" (default): reproduce the reference's EFFECTIVE tap gains,
      which convert dB -> linear TWICE — RayleighMultiPathChannel first maps
      10^(dB/20) (/root/reference/core/channel.py:184) and
      RayleighChannel.__init__ then maps the result through 10^(x/20) AGAIN
      (core/rayleighchannel.py:16). The composition 10^(10^(dB/20)/20)
      makes all ITU taps nearly equal amplitude (Ped-A: 1.122, 1.038,
      1.013, 1.008) — i.e. the reference actually simulates a strongly
      frequency-selective near-uniform tap channel, not the published
      power-delay profile. Preserved so BER curves match the reference
      within Monte-Carlo bounds.
    - "physical": the correct single conversion 10^(dB/20) (use for
      standards-faithful ITU-R M.1225 simulation).
    """
    prof = ITU_CHANNEL_MODELS[itu_profile]
    delays_s = np.asarray(prof["delays_us"]) * 1e-6
    lin_once = 10.0 ** (np.asarray(prof["power_db"]) / 20.0)
    if gain_convention == "reference":
        gains_arr = 10.0 ** (lin_once / 20.0)
    elif gain_convention == "physical":
        gains_arr = lin_once
    else:
        raise ValueError(f"unknown gain_convention {gain_convention}")
    gains = tuple(float(g) for g in gains_arr)
    delays = tuple(int(round(d * fs)) for d in delays_s)
    if fd is None:
        v = velocity_kmh if velocity_kmh is not None \
            else ITU_DEFAULT_VELOCITY_KMH[itu_profile]
        fd = doppler_hz(v, frequency_ghz)
    return MultipathProfile(itu_profile + "/" + gain_convention, delays,
                            gains, float(fd), float(fs))


def jakes_taps(key: jax.Array, profile: MultipathProfile, num_samples: int,
               batch_shape: tuple = (), sample_stride: int = 1) -> C:
    """Time-varying complex tap gains h_i(t), shape (*batch, num_taps, T).

    One complex matmul: E (T, Ns) @ P (Ns, batch·taps). sample_stride
    evaluates the sinusoids every `stride` samples of the fs clock (the
    tap-hold path in apply_multipath).
    """
    T = num_samples
    ns = N_SINUSOIDS
    t = jnp.arange(T, dtype=jnp.float32) * (sample_stride / profile.fs)
    alpha = 2.0 * np.pi * np.arange(1, ns + 1) / ns
    omega = (2.0 * np.pi * profile.doppler_hz * np.cos(alpha)).astype(np.float32)
    # build the sinusoid matrix TRANSPOSED so the matmul emits (L, T)
    # directly — the (T, L) orientation needed a full transpose copy of
    # the tap waveforms (2·8·L·T bytes of pure HBM traffic; at the SIMO
    # 1x4 bench shape that is ~500 MB/step)
    E = cplx.expi(omega[:, None] * t[None, :])                # (Ns, T)

    L = int(np.prod(batch_shape, dtype=int)) * profile.num_taps
    phi = jax.random.uniform(key, (L, ns), jnp.float32, 0.0, 2.0 * np.pi)
    P = cplx.expi(phi)                                        # (L, Ns)

    H = cplx.matmul(P, E, precision=matmul_precision()) * np.sqrt(2.0 / ns)  # (L, T)
    return H.reshape(batch_shape + (profile.num_taps, T))


def _tap_hold(T: int, profile: MultipathProfile) -> int:
    """Tap-hold granularity: generate Jakes taps every `hold` samples and
    hold inside the block. OFDM_LTE_TPU_TAP_HOLD = "1" (default: exact,
    per-sample — the float-faithful arbiter) | "auto" | an integer. "auto"
    picks the largest divisor of T with fd·hold/fs <= 2% — the channel then
    moves >= 50x finer than its own coherence time, FAR finer than the
    receiver's slot-constant CRS assumption — capped at 4096. It removes
    the (links·taps, T) tap-waveform write and re-read from device memory;
    on the GPU it measured faster for SIMO and slower for SFBC (PERF.md),
    so it is opt-in."""
    import os
    mode = os.environ.get("OFDM_LTE_TPU_TAP_HOLD", "1").lower()
    if mode != "auto":
        return max(1, int(mode))
    fd = max(profile.doppler_hz, 1e-3)
    max_h = min(int(0.02 * profile.fs / fd), 4096, T)
    for h in range(max_h, 1, -1):
        if T % h == 0:
            return h
    return 1


def apply_multipath(key: jax.Array, x: C, profile: MultipathProfile,
                    hold: int = None) -> C:
    """Faded signal y(t) = Σ_i g_i h_i(t) x(t-d_i); x: (..., T) -> (..., T).

    Fresh fading per call (independent channel realization), as the reference
    draws new Jakes phases for every transmission (rayleighchannel.py:31).
    hold: tap-hold granularity (None = env/backend default, see _tap_hold).
    """
    T = x.shape[-1]
    batch = x.shape[:-1]
    if hold is None:
        hold = _tap_hold(T, profile)
    if hold > 1 and T % hold:
        # A manual hold (env var or argument) that does not divide T would
        # crash below at the (Tg, hold) reshape with an opaque shape error;
        # round DOWN to the largest divisor of T instead —
        # "auto" always returns a divisor, so this only triggers for
        # manual values.
        hold = next(h for h in range(min(hold, T), 0, -1) if T % h == 0)
    Tg = T // hold if hold > 1 else T
    taps = jakes_taps(key, profile, Tg, batch,
                      sample_stride=hold)                     # (..., taps, Tg)

    y_re = jnp.zeros_like(x.re)
    y_im = jnp.zeros_like(x.im)
    for i, (d, g) in enumerate(zip(profile.delays_samples, profile.gains_linear)):
        if d == 0:
            xd = x
        else:
            xd = C(
                jnp.pad(x.re, [(0, 0)] * len(batch) + [(d, 0)])[..., :T],
                jnp.pad(x.im, [(0, 0)] * len(batch) + [(d, 0)])[..., :T],
            )
        h = taps[..., i, :]
        if hold > 1:
            # broadcast each held tap value over its block: the (..., T)
            # product computes as (..., Tg, hold) without materializing
            # an upsampled tap waveform
            xb = xd.reshape(batch + (Tg, hold))
            hb = C(h.re[..., None], h.im[..., None])          # (..., Tg, 1)
            prod = (hb * xb).reshape(batch + (T,))
        else:
            prod = h * xd
        y_re = y_re + g * prod.re
        y_im = y_im + g * prod.im
    return C(y_re, y_im)


def rayleigh_multipath(key: jax.Array, x: C, snr_db, profile: MultipathProfile,
                       measure_axes=None) -> C:
    """Multipath fading + AWGN at SNR relative to post-fading power
    (/root/reference/core/channel.py:203-234)."""
    kf, kn = jax.random.split(key)
    y = apply_multipath(kf, x, profile)
    return awgn(kn, y, snr_db, measure_axes=measure_axes)


def flat_fading(key: jax.Array, x: C, snr_db) -> C:
    """Per-sample iid CN(0,1) multiplicative fading + AWGN (legacy
    FadingChannel, /root/reference/core/channel.py:248-291)."""
    kh, kn = jax.random.split(key)
    h = _cn01(kh, x.shape)
    return awgn(kn, h * x, snr_db)


def _cn01(key: jax.Array, shape) -> C:
    kr, ki = jax.random.split(key)
    s = 1.0 / np.sqrt(2.0)
    return C(jax.random.normal(kr, shape, jnp.float32) * s,
             jax.random.normal(ki, shape, jnp.float32) * s)


def flat_mimo_matrix(key: jax.Array, num_rx: int, num_tx: int,
                     batch_shape: tuple = ()) -> C:
    """iid CN(0,1) flat MIMO link matrix H[..., rx, tx]
    (/root/reference/core/channel.py:471-477)."""
    return _cn01(key, batch_shape + (num_rx, num_tx))


def flat_mimo_time_varying(key: jax.Array, num_rx: int, num_tx: int,
                           num_symbols: int, doppler_hz: float,
                           symbol_duration_s: float = 1.0 / 15000.0,
                           batch_shape: tuple = ()) -> C:
    """Jakes-evolved flat MIMO channel H[..., s, rx, tx] sampled once per
    OFDM symbol — the time-varying channel the reference's
    AdaptiveBeamforming is DESIGNED for but never receives (its
    simulate_beamforming draws one constant H per call,
    /root/reference/core/ofdm_core.py:2347-2349, while
    beamforming_precoder.py:202-293 recomputes W every ~0.1·Tc).

    Each (rx, tx) element fades independently with the same Jakes
    sum-of-sinusoids model as the multipath taps, normalized to a unit-power
    stationary marginal (E|h|²=1, matching flat_mimo_matrix's CN(0,1)
    statistics — NOT the multipath path's preserved E|h|²=2 reference
    quirk, since this extension has no reference output to match).
    symbol_duration_s defaults to the reference's 1/15 kHz convention
    (beamforming_precoder.py:253-255), independent of bandwidth.

    One complex matmul: E (S, Ns) @ P (Ns, batch·rx·tx).
    """
    S, ns = num_symbols, N_SINUSOIDS
    t = jnp.arange(S, dtype=jnp.float32) * symbol_duration_s
    alpha = 2.0 * np.pi * np.arange(1, ns + 1) / ns
    omega = (2.0 * np.pi * doppler_hz * np.cos(alpha)).astype(np.float32)
    E = cplx.expi(t[:, None] * omega[None, :])                # (S, Ns)

    L = int(np.prod(batch_shape, dtype=int)) * num_rx * num_tx
    phi = jax.random.uniform(key, (ns, L), jnp.float32, 0.0, 2.0 * np.pi)
    P = cplx.expi(phi)                                        # (Ns, L)

    H = cplx.matmul(E, P, precision=matmul_precision()) * np.sqrt(1.0 / ns)
    H = H.reshape((S,) + batch_shape + (num_rx, num_tx))      # (S, ..., r, t)
    # batch axes lead: (..., S, rx, tx)
    perm = tuple(range(1, 1 + len(batch_shape))) + (0,) + (
        1 + len(batch_shape), 2 + len(batch_shape))
    return H.transpose(*perm)


def impulse_response(key: jax.Array, profile: MultipathProfile):
    """One instantaneous complex tap per path: (delays_samples, taps C)
    (/root/reference/core/rayleighchannel.py:95-109)."""
    taps = jakes_taps(key, profile, 1, ())            # (num_taps, 1)
    g = jnp.asarray(profile.gains_linear, jnp.float32)
    return (np.asarray(profile.delays_samples),
            C(taps.re[:, 0] * g, taps.im[:, 0] * g))


def frequency_response(taps: C, profile: MultipathProfile,
                       freqs_hz: jnp.ndarray) -> C:
    """Analytic H(f) = Σ h_i·exp(-2πi·f·τ_i) for given instantaneous taps
    (/root/reference/core/rayleighchannel.py:76-92). taps: C (num_taps,)."""
    tau = jnp.asarray(profile.delays_samples, jnp.float32) / profile.fs
    phase = -2.0 * np.pi * freqs_hz[..., None] * tau      # (..., taps)
    e = cplx.expi(phase)
    t = C(taps.re, taps.im)
    return (C(t.re, t.im) * e).sum(axis=-1)


def path_loss_linear(key: jax.Array, distance_m, frequency_hz=2e9,
                     pl0_db: float = 30.0, exponent: float = 3.5,
                     shadowing_sigma_db: float = 4.0, d0: float = 100.0):
    """Log-distance path loss + log-normal shadowing, as a linear amplitude
    factor (/root/reference/core/rayleighchannel.py:60-74):
        PL(dB) = PL0 + 10·n·log10(d/d0) + N(0, σ);  return 10^(-PL/20).
    """
    d = jnp.asarray(distance_m, jnp.float32)
    pl_db = pl0_db + 10.0 * exponent * jnp.log10(d / d0)
    shadow = jax.random.normal(key, jnp.shape(d)) * shadowing_sigma_db
    return 10.0 ** (-(pl_db + shadow) / 20.0)
