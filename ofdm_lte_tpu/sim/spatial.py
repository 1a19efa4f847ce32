"""TM4 spatial multiplexing: layer mapping, codebook precoding, orthogonal
CRS, MMSE/ZF/SIC detection.

Functional replacement for the module-level simulate_spatial_multiplexing
(/root/reference/core/ofdm_core.py:2489-2816). Reference semantics kept:

- rank/PMI decided ONCE per call from an initial channel draw
  (ofdm_core.py:2573-2589); the decision is made at trace time (NumPy)
  because the chosen rank sets downstream array shapes
- per OFDM symbol: nd QAM symbols -> zero-pad to rank multiple -> layers
  (rank, m); precoded onto the FIRST m data bins only, the rest stay zero
  (ofdm_core.py:2610-2640)
- orthogonal CRS per TX on every step-th pilot bin (ofdm_core.py:2642-2654)
- channel: flat iid CN(0,1) per link, or per-link multipath
  (channel.py:397-493)
- per-SYMBOL CRS estimation of H[rx, tx, k] (ofdm_core.py:2743-2758 — note:
  per symbol here, not per slot)
- batched (rank×rank) MIMO detection with the TX precoder W
  (mimo_detector.py), layer demap, hard demap, BER
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, orthogonal_pilot_indices
from ..ops import qam, ofdm
from ..channel.mimo import spatial_mix_noiseless
from ..channel.rayleigh import make_profile, flat_mimo_matrix
from ..rx import estimation as est
from ..rx.mimo_estimation import estimate_per_tx_planes
from ..mimo import codebook as cb
from ..mimo import layer_mapper, detector
from ..mimo.rank_adaptation import get_feedback


class SpatialResult(NamedTuple):
    bits_rx: jnp.ndarray
    bit_errors: jnp.ndarray
    ber: jnp.ndarray
    symbols_rx: C
    papr_db: jnp.ndarray    # (...,) mean over TX antennas (as sfbc)


def decide_rank_pmi(num_tx: int, num_rx: int, snr_db: float,
                    rank="adaptive", seed: int = 0):
    """Trace-time rank/PMI decision from an initial CN(0, 1/num_tx) draw
    (ofdm_core.py:2573-2589). Returns (rank_used, pmi, W numpy)."""
    if rank == "adaptive":
        rng = np.random.RandomState(seed)
        H0 = (rng.randn(num_rx, num_tx) + 1j * rng.randn(num_rx, num_tx)) \
            / np.sqrt(2 * num_tx)
        fb = get_feedback(H0, snr_db)
        return fb["ri"], fb["pmi"], fb["W"]
    rank_used = int(rank)
    W = cb.get_precoder(0, num_tx, "TM4", rank_used)
    return rank_used, 0, W


@functools.lru_cache(maxsize=None)
def _pilot_bin_union_values(N: int, Nc: int, num_tx: int,
                            layout: str = "reference"):
    """Per-TX transmitted values over the UNION CRS pilot grid: TX t carries
    pilot_sequence(t%4) on every step-th union bin with offset t, zeros on
    the other TXs' bins (ofdm_core.py:2642-2654 realized on the bin grid).
    Returns a list of num_tx complex (n_pilot_union,) NumPy vectors.

    NOTE reference layout at 8 TX: TX t and t+4 share bins, so the union
    value is the SUM of both sequences on those bins (the collision the
    "extended" layout removes)."""
    from ..grid import make_grid, pilot_sequence, pilot_step
    g = make_grid(N, Nc)
    step = pilot_step(num_tx, layout)
    out = []
    for tx in range(num_tx):
        v = np.zeros(g.num_pilot, np.complex128)
        n = len(g.pilot_idx[tx % step::step])
        v[tx % step::step] = pilot_sequence(tx % 4, n)
        out.append(v)
    return out


@functools.partial(jax.jit, static_argnames=(
    "config", "num_tx", "num_rx", "rank_used", "detector_type",
    "channel_type", "itu_profile", "velocity_kmh", "frequency_ghz",
    "channel_impl", "pilot_layout"))
def _simulate_spatial_jit(key, bits, snr_db, W_re, W_im, config: LTEConfig,
                          num_tx: int, num_rx: int, rank_used: int,
                          detector_type: str, channel_type: str,
                          itu_profile: str, velocity_kmh,
                          frequency_ghz,
                          channel_impl: str = "time",
                          pilot_layout: str = "reference") -> SpatialResult:
    g = grid_for(config)
    nd = g.num_data
    bps = config.bits_per_symbol
    lead = bits.shape[:-1]
    S = bits.shape[-1] // (nd * bps)
    W = C(W_re, W_im)                                     # (num_tx, rank)

    padded = layer_mapper.padded_length(nd, rank_used)
    m = padded // rank_used                               # symbols per layer

    profile = None
    if channel_type == "rayleigh_mp":
        profile = make_profile(itu_profile, config.fs, velocity_kmh,
                               frequency_ghz)

    # ---- TX ----
    syms = qam.modulate(bits, config.modulation).reshape(lead + (S, nd))
    syms = cplx.pad(syms, [(0, 0)] * (syms.ndim - 1) + [(0, padded - nd)])
    layers = layer_mapper.map_to_layers(syms, rank_used)  # (..., S, L, m)

    # precode: x[tx, k] = Σ_l W[tx,l]·layers[l,k]  -> (..., S, tx, m)
    # (tiny (tx×L) contraction -> broadcast-FMA, not a dot)
    x = cplx.matmul_small(W, layers)

    pil_idx = orthogonal_pilot_indices(config, num_tx, pilot_layout)
    kch, kd, kp = jax.random.split(key, 3)
    noise_var = 10.0 ** (-jnp.asarray(snr_db, jnp.float32) / 10.0)
    snr_lin = 10.0 ** (jnp.asarray(snr_db, jnp.float32) / 10.0)

    if channel_impl == "bins":
        # ---- flat channel, bin domain (PARITY.md divergence: algebraic
        # identity, not an approximation) ----
        # For a FLAT channel the modem DFT round trip is exactly the
        # identity on the occupied bins (the TX signal is a sum of
        # exponentials at bin frequencies over the CP-stripped N-window),
        # so  Y[rx, k] = Σ_tx H[rx,tx]·X[tx, k] + noise  holds EXACTLY —
        # no RX time signal, no per-RX DFT matmuls, no mixing pass over
        # the (num_tx + num_rx)·T sample arrays. The TX time signals ARE
        # still synthesized (one batched matmul over the antenna axis)
        # because PAPR and the reference's measured-power noise convention
        # (P_rx = mean_t |y_rx(t)|², channel.py:458-464) are time-domain
        # quantities; P_rx is recovered exactly (up to fp reassociation)
        # from the TX cross-correlation matrix
        #   P_r = Σ_{t1,t2} Re(H[r,t1]·H*[r,t2]·R[t1,t2]),
        #   R[t1,t2] = mean_t x_t1(t)·x_t2*(t).
        sig4 = ofdm.modulate_custom_multi(
            x, config, g.data_idx[:m],
            tuple(tuple(int(b) for b in p) for p in pil_idx),
            tuple(tx % 4 for tx in range(num_tx)))        # (..., S, tx, sps)
        papr = jnp.mean(ofdm.papr_db(sig4, axis=(-3, -1)), axis=-1)

        H = flat_mimo_matrix(kch, num_rx, num_tx, lead)   # (..., rx, tx)

        def tx_plane(t):
            return C(sig4.re[..., t, :], sig4.im[..., t, :])

        R = {}
        for t1 in range(num_tx):
            for t2 in range(t1, num_tx):
                R[(t1, t2)] = (tx_plane(t1) * tx_plane(t2).conj()).mean(
                    axis=(-2, -1))                        # (...,) complex

        def h_el(r, t):
            return C(H.re[..., r, t], H.im[..., r, t])    # (...,)

        p_rx = []
        for r in range(num_rx):
            p = None
            for t1 in range(num_tx):
                term = h_el(r, t1).abs2() * R[(t1, t1)].re
                p = term if p is None else p + term
                for t2 in range(t1 + 1, num_tx):
                    cross = h_el(r, t1) * h_el(r, t2).conj() * R[(t1, t2)]
                    p = p + 2.0 * cross.re
            p_rx.append(p)                                # (...,)
        npow = jnp.stack(p_rx, axis=0) / snr_lin          # (rx, ...)
        npw = npow[..., None, None]                       # (rx, ..., 1, 1)
        std = jnp.sqrt(npw / 2.0)

        # one RNG call per (data, pilot) noise block, sliced per RX —
        # same draw structure/count as the time path's add_cn
        kdr, kdi = jax.random.split(kd)
        nre_d = jax.random.normal(kdr, (num_rx,) + lead + (S, m), jnp.float32)
        nim_d = jax.random.normal(kdi, (num_rx,) + lead + (S, m), jnp.float32)
        kpr, kpi = jax.random.split(kp)
        npil = (num_rx,) + lead + (S, g.num_pilot)
        nre_p = jax.random.normal(kpr, npil, jnp.float32)
        nim_p = jax.random.normal(kpi, npil, jnp.float32)

        pil_vals = _pilot_bin_union_values(config.N, config.Nc, num_tx,
                                           pilot_layout)
        y_planes, ypil_planes = [], []
        for r in range(num_rx):
            acc = None
            pacc = None
            for t in range(num_tx):
                h_rt = h_el(r, t)
                hb = C(h_rt.re[..., None, None], h_rt.im[..., None, None])
                term = hb * C(x.re[..., t, :], x.im[..., t, :])
                acc = term if acc is None else acc + term
                pterm = hb * cplx.const(pil_vals[t])
                pacc = pterm if pacc is None else pacc + pterm
            y_planes.append(C(acc.re + nre_d[r] * std[r],
                              acc.im + nim_d[r] * std[r]))
            ypil_planes.append(C(pacc.re + nre_p[r] * std[r],
                                 pacc.im + nim_p[r] * std[r]))
    else:
        # ---- generic time-domain channel (multipath / parity arbiter) ----
        tx_sigs = []
        for tx in range(num_tx):
            data_tx = x[..., tx, :]                       # (..., S, m)
            sig = ofdm.modulate_custom(data_tx, config, g.data_idx[:m],
                                       pil_idx[tx], tx % 4)
            tx_sigs.append(sig.reshape(
                lead + (S * config.samples_per_ofdm_symbol,)))
        signals_tx = cplx.stack(tx_sigs, axis=0)          # (num_tx, ..., T)
        papr = jnp.mean(ofdm.papr_db(signals_tx, axis=-1), axis=0)

        # channel (fading/mixing only; noise goes in at the bins)
        y, _H, npow = spatial_mix_noiseless(kch, signals_tx, snr_db, num_rx,
                                            channel_type, profile)

        # Per-RX AWGN injected at the demodulated bins: the DFT is unitary
        # and the detector only ever sees these bins, so CN(0, P_rx/snr)
        # here is statistically identical to the time-domain injection
        # (the sim/siso._receive_awgn_freq argument) at ~3x less Gaussian
        # volume.
        yf = ofdm.frame_stream(y, config)                 # (rx, ..., S, sps)
        npw = npow[..., None, None]                       # (rx, ..., 1, 1)

        def add_cn(k, v):
            kr, ki = jax.random.split(k)
            std = jnp.sqrt(npw / 2.0)
            return C(v.re + jax.random.normal(kr, v.re.shape,
                                              jnp.float32) * std,
                     v.im + jax.random.normal(ki, v.im.shape,
                                              jnp.float32) * std)

        y_data = add_cn(kd, ofdm.demodulate_bins(yf, config, g.data_idx[:m]))
        y_pil = add_cn(kp, ofdm.demodulate_bins(yf, config, g.pilot_idx))
        y_planes = [C(y_data.re[r], y_data.im[r]) for r in range(num_rx)]
        ypil_planes = [C(y_pil.re[r], y_pil.im[r]) for r in range(num_rx)]

    # ---- estimation + detection, all in per-(rx, tx) PLANES ----
    # per-symbol CRS estimation (ofdm_core.py:2743-2758): h_planes[r][t]
    # is (..., S, m) — no stacked (rx, tx)-trailing arrays, so the
    # detector's operands keep the subcarrier axis minor
    h_planes = [estimate_per_tx_planes(ypil_planes[r], config, num_tx,
                                       out_bins=g.data_idx[:m],
                                       layout=pilot_layout)
                for r in range(num_rx)]

    dt = detector_type.upper()
    if dt in ("MMSE", "IRC", "ZF", "SIC") and rank_used in (1, 2, 3, 4):
        # effective channel per plane: heff[r][l] = Σ_t h[r][t]·W[t,l]
        heff = []
        for r in range(num_rx):
            row = []
            for l in range(rank_used):
                acc = None
                for t in range(num_tx):
                    term = h_planes[r][t] * C(W.re[t, l], W.im[t, l])
                    acc = term if acc is None else acc + term
                row.append(acc)
            heff.append(row)
        if dt == "SIC":
            s_planes = detector.sic_planes(y_planes, heff, noise_var,
                                           config.modulation)
        else:
            # ZF is the same regularized gram solve with σ² -> ε
            # (mimo.detector.zf's regularization=1e-9)
            s2 = jnp.float32(1e-9) if dt == "ZF" else noise_var
            s_planes = detector.mmse_planes(y_planes, heff, s2)
        # interleave layers back to symbol order: stack on a NEW minor
        # axis gives (..., S, m, L) = demap_from_layers' transposed form
        syms_rx = C(jnp.stack([p.re for p in s_planes], axis=-1),
                    jnp.stack([p.im for p in s_planes], axis=-1))
        syms_rx = syms_rx.reshape(lead + (S, m * rank_used))[..., :nd]
    else:
        # generic detectors (MRC/MMSE-U): stacked
        # (..., S, m, rx[, tx]) layout + batched solves
        y_det = C(jnp.stack([p.re for p in y_planes], axis=-1),
                  jnp.stack([p.im for p in y_planes], axis=-1))
        h_det = C(
            jnp.stack([jnp.stack([h_planes[r][t].re for t in range(num_tx)],
                                 axis=-1) for r in range(num_rx)], axis=-2),
            jnp.stack([jnp.stack([h_planes[r][t].im for t in range(num_tx)],
                                 axis=-1) for r in range(num_rx)], axis=-2))
        layers_rx = detector.detect(y_det, h_det, noise_var,
                                    detector_type=detector_type, W=W,
                                    modulation=config.modulation)
        # (..., S, m, L) -> (..., S, L, m)
        layers_rx = C(layers_rx.re.swapaxes(-1, -2),
                      layers_rx.im.swapaxes(-1, -2))
        syms_rx = layer_mapper.demap_from_layers(layers_rx,
                                                 original_length=nd)

    flat = syms_rx.reshape(lead + (S * nd,))
    bits_rx = qam.demodulate(flat, config.modulation).astype(bits.dtype)
    errors = jnp.sum((bits_rx != bits).astype(jnp.int32), axis=-1)
    return SpatialResult(bits_rx, errors, errors / bits.shape[-1], syms_rx,
                         papr)


def simulate_spatial_multiplexing(key, bits, snr_db, config: LTEConfig = None,
                                  num_tx: int = 4, num_rx: int = 2,
                                  rank="adaptive", detector_type: str = "MMSE",
                                  modulation: str = None,
                                  channel_type: str = "awgn",
                                  itu_profile: str = "Pedestrian_A",
                                  velocity_kmh: float = 3.0,
                                  frequency_ghz: float = 2.0,
                                  seed: int = 0,
                                  pilot_layout: str = "reference"
                                  ) -> SpatialResult:
    """Public entry matching the reference signature (ofdm_core.py:2489).

    pilot_layout="extended" (divergence, PARITY.md): disjoint CRS combs
    for ALL TX antennas. The reference caps the FDM step at 4
    (mimo_channel_estimator_periodic.py:75-106), so its 8-TX spatial
    estimates collide pairwise and the capstone 8x4 shape is degenerate
    (BER ~0.4 in both implementations); "extended" makes 8 TX usable.
    Identical to "reference" for num_tx <= 4."""
    if config is None:
        config = LTEConfig(modulation=modulation or "64-QAM")
    if rank == "adaptive":
        # rank decision needs a concrete SNR (shapes depend on it)
        snr_static = float(np.asarray(snr_db).mean())
    else:
        snr_static = 0.0   # unused for fixed rank (W = codebook PMI 0)
    rank_used, _pmi, W = decide_rank_pmi(num_tx, num_rx, snr_static, rank,
                                         seed)
    # the flat ("awgn"/iid) channel runs in the bin domain by default — an
    # exact algebraic identity, see _simulate_spatial_jit. Set
    # OFDM_LTE_TPU_SPATIAL_CHANNEL=time to force the time-domain arbiter
    # path (read at trace time, like OFDM_LTE_TPU_CMATMUL).
    if channel_type == "rayleigh_mp":
        channel_impl = "time"
    else:
        channel_impl = os.environ.get("OFDM_LTE_TPU_SPATIAL_CHANNEL",
                                      "bins").lower()
        if channel_impl not in ("bins", "time"):
            raise ValueError(
                f"OFDM_LTE_TPU_SPATIAL_CHANNEL={channel_impl!r}; "
                "pick from ['bins', 'time']")
    return _simulate_spatial_jit(
        key, bits, snr_db,
        jnp.asarray(W.real, jnp.float32), jnp.asarray(W.imag, jnp.float32),
        config, num_tx, num_rx, rank_used, detector_type, channel_type,
        itu_profile, velocity_kmh, frequency_ghz, channel_impl,
        pilot_layout)


def bits_per_frame(config: LTEConfig, num_ofdm_symbols: int) -> int:
    return grid_for(config).num_data * config.bits_per_symbol * num_ofdm_symbols
