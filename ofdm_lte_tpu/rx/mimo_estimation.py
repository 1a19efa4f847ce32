"""Per-TX CRS channel estimation for MIMO with FDM-orthogonal pilots.

Implements the *intended* behavior of
/root/reference/core/mimo_channel_estimator_periodic.py (whose
estimate_channel_periodic path crashes as written — it unpacks 3 values from
a 2-tuple at line 219; SURVEY §2.4 directs the build to realize the intended
per-TX slot-periodic estimates):

- TX t transmits CRS on every step-th pilot bin with offset t (step =
  min(num_tx, 4)), using the cell_id = t%4 pilot sequence
  (mimo_channel_estimator_periodic.py:88-106).
- Per (rx, tx): LS at that TX's pilot bins, linear interpolation to all/
  selected bins (reusing LTEChannelEstimator._interpolate_channel semantics,
  lines 160-171), estimated once per 14-symbol slot and reused inside the
  slot.
"""
from __future__ import annotations

from typing import List

import numpy as np
import jax.numpy as jnp

import functools

from .. import cplx
from ..cplx import C
from ..config import LTEConfig
from ..grid import grid_for, pilot_sequence, orthogonal_pilot_indices
from . import estimation as est


@functools.lru_cache(maxsize=None)
def _tap_basis_projection(pilot_idx: tuple, out_bins: tuple, N: int,
                          num_taps: int = None) -> np.ndarray:
    """Delay-domain LS projection matrix A (P, n_out): Ĥ[out] = Ĥ[pilots]·A.

    Models the channel as H[k] = Σ_d h_d·exp(-2πi·k·d/N) over delays
    d = 0..D-1 (D = num_taps) and solves the LS fit at the pilot comb,
    reconstructing H at the output bins:
        A = pinv(F_p) @ F_outᵀ,  F[k, d] = exp(-2πi·k·d/N).
    Exact for any channel whose delay spread is < D samples, where linear
    interpolation across a SPARSE comb (step 8 -> ~48-bin gaps at 10 MHz)
    breaks down — the phase of a 6-sample-delay tap rotates ~100° per gap.
    One tiny complex matmul per (rx, tx) at apply time (one dense matmul).

    Default D = max(4, 3P//5): an over-determined fit that averages pilot
    noise by ~P/D while covering pedestrian-class delay spreads
    ((D-1)/fs ≈ 390 ns at 10 MHz) — measured 8x4 64-QAM @25 dB rank-2
    medians 0.052 (D=P, no averaging) vs 1.7e-4 (D=7). Profiles with
    longer tails (Vehicular/Bad-Urban at wide BW) exceed ANY D ≤ P at
    step-8 combs; pass num_taps explicitly to trade noise for reach.
    """
    p = np.asarray(pilot_idx, np.float64)
    k = np.asarray(out_bins, np.float64)
    P = len(p)
    D = num_taps if num_taps is not None else max(4, (3 * P) // 5)
    D = min(D, P)
    d = np.arange(D)
    F_p = np.exp(-2j * np.pi * p[:, None] * d[None, :] / N)    # (P, D)
    F_o = np.exp(-2j * np.pi * k[:, None] * d[None, :] / N)    # (n_out, D)
    A = np.linalg.pinv(F_p).T @ F_o.T                          # (P, n_out)
    return np.ascontiguousarray(A.astype(np.complex64))


def estimate_per_tx_planes(pilot_bins_rx: C, config: LTEConfig, num_tx: int,
                           out_bins: np.ndarray,
                           layout: str = "reference") -> List[C]:
    """Per-TX estimates as a LIST of planes (no trailing tx axis).

    pilot_bins_rx: C (..., n_pilot_all) — received values at ALL CRS pilot
    bins (the union over TX) for one RX. Returns [num_tx] C planes of
    shape (..., len(out_bins)). The plane form feeds the spatial
    pipeline's plane-based detector (mimo.detector.mmse2_planes) without
    materializing a (..., tx, n_out) stacked array.

    layout: "reference" (step=min(num_tx,4); 8 TX COLLIDE pairwise, the
    reference's shipped behavior) or "extended" (step=num_tx, disjoint
    combs — see grid.pilot_step / PARITY.md)."""
    from ..grid import pilot_step
    from ..precision import matmul_precision
    g = grid_for(config)
    step = pilot_step(num_tx, layout)
    per_tx = []
    for tx in range(num_tx):
        idx = g.pilot_idx[tx % step::step]
        rx_p = pilot_bins_rx[..., tx % step::step]
        known = cplx.const(pilot_sequence(tx % 4, len(idx)))
        h_p = rx_p * known.conj()          # unit-modulus pilots: Y/X = Y·X*
        if layout == "extended" and step > 4:
            # sparse comb (>4-TX FDM): linear interpolation across the
            # wide gaps breaks down on frequency-selective channels —
            # reconstruct through the delay-domain LS basis instead
            # (one small complex matmul; exact for delay spread < P taps)
            A = _tap_basis_projection(tuple(int(b) for b in idx),
                                      tuple(int(b) for b in out_bins),
                                      config.N)
            h = cplx.matmul(h_p, cplx.const(A),
                            precision=matmul_precision())
        else:
            h = est.interpolate(h_p, config, out_bins=out_bins,
                                pilot_idx=idx)
        per_tx.append(h)
    return per_tx


def estimate_per_tx(pilot_bins_rx: C, config: LTEConfig, num_tx: int,
                    out_bins: np.ndarray, layout: str = "reference") -> C:
    """Estimate H for each TX from the full received pilot-bin vector.

    pilot_bins_rx: C (..., n_pilot_all) — received values at ALL CRS pilot
    bins (the union over TX). Returns C (..., num_tx, len(out_bins)).
    """
    return cplx.stack(
        estimate_per_tx_planes(pilot_bins_rx, config, num_tx, out_bins,
                               layout),
        axis=-2)                           # (..., num_tx, n_out)
