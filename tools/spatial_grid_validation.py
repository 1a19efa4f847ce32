"""Spatial-multiplexing validation grid at the reference's published test
shapes (VERDICT r3 task 4).

The reference's capstone spatial test
(/root/reference/test/test_spatial_multiplexing.py:44-49, 229-237) runs
2x2 / 4x2 / 4x4 / 8x4 with MMSE vs SIC, rank='adaptive', 64-QAM,
SNR 25 dB, 10 MHz, rayleigh_mp Pedestrian_A @3 km/h, one OFDM symbol per
call. This tool runs that grid on BOTH implementations:

- reference: its frozen realization (the global-RNG pilot reseed makes
  every call deterministic for fixed bits — VALIDATION.md), a few symbols
  accumulated, run in-process with prints silenced;
- ours: lanes of independent channel realizations of the same per-call
  workload (CPU, f32).

and asserts the reference's frozen draw falls inside our Monte-Carlo
spread (per-lane min/max padded by the binomial counting grain). Output:
results/spatial_grid_validation.json (consumed by
tests/test_spatial.py::test_grid_validation_artifact).

Usage: JAX_PLATFORMS=cpu python tools/spatial_grid_validation.py
"""
import contextlib
import io
import json
import os
import sys
import datetime

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

SNR_DB = 25.0
BW = 10.0
MOD = "64-QAM"
N_SYM_REF = 2      # reference OFDM symbols accumulated (deterministic anyway)
LANES = 32         # our Monte-Carlo realizations
N_SYM_OURS = 2     # symbols per lane (matches the per-call reference shape)
CONFIGS = [(2, 2), (4, 2), (4, 4), (8, 4)]
DETECTORS = ["MMSE", "SIC"]


def run_reference(num_tx, num_rx, det):
    sys.path.insert(0, "/root/reference")
    from core.ofdm_core import simulate_spatial_multiplexing as ref_spatial
    from config import LTEConfig as RefConfig
    cfg = RefConfig(modulation=MOD, bandwidth=BW)
    from core.resource_mapper import ResourceMapper
    nd = len(ResourceMapper(cfg).get_data_indices())
    bps = 6
    rng = np.random.RandomState(1234)
    errors = 0
    total = 0
    ranks = []
    for s in range(N_SYM_REF):
        bits = rng.randint(0, 2, nd * bps)
        with contextlib.redirect_stdout(io.StringIO()):
            r = ref_spatial(bits=bits, num_tx=num_tx, num_rx=num_rx,
                            rank="adaptive", detector_type=det,
                            modulation=MOD, snr_db=SNR_DB, config=cfg,
                            channel_type="rayleigh_mp",
                            itu_profile="Pedestrian_A", velocity_kmh=3,
                            frequency_ghz=2.0, enable_csi_feedback=True,
                            enable_parallel=False)
        errors += int(r["bit_errors"])
        total += len(bits)
        ranks.append(int(r.get("rank", 0)))
    return errors / total, ranks


def run_ours(num_tx, num_rx, det):
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import spatial
    cfg = LTEConfig(bandwidth=BW, modulation=MOD)
    n_bits = spatial.bits_per_frame(cfg, N_SYM_OURS)
    bits = jnp.asarray(np.random.default_rng(99).integers(
        0, 2, (LANES, n_bits)).astype(np.int32))
    r = spatial.simulate_spatial_multiplexing(
        jax.random.PRNGKey(42), bits, SNR_DB, cfg, num_tx=num_tx,
        num_rx=num_rx, rank="adaptive", detector_type=det,
        channel_type="rayleigh_mp", itu_profile="Pedestrian_A",
        velocity_kmh=3.0)
    bers = np.asarray(r.ber, np.float64)
    return bers, n_bits


def main():
    out = {"snr_db": SNR_DB, "bandwidth": BW, "modulation": MOD,
           "channel": "rayleigh_mp Pedestrian_A 3km/h",
           "reference_symbols": N_SYM_REF,
           "ours": f"{LANES} lanes x {N_SYM_OURS} symbols",
           "measured": datetime.date.today().isoformat(), "grid": []}
    all_pass = True
    for num_tx, num_rx in CONFIGS:
        for det in DETECTORS:
            ref_ber, ref_ranks = run_reference(num_tx, num_rx, det)
            bers, n_bits = run_ours(num_tx, num_rx, det)
            # binomial counting grain of the reference's short sample +
            # our per-lane grain
            grain = max(3.0 / n_bits,
                        3.0 * float(np.sqrt(max(ref_ber, 1e-9)
                                            * (1 - ref_ber) / n_bits)))
            lo, hi = float(bers.min()) - grain, float(bers.max()) + grain
            ok = lo <= ref_ber <= hi
            all_pass &= ok
            row = {"config": f"{num_tx}x{num_rx}", "detector": det,
                   "ref_ber": round(ref_ber, 6),
                   "ref_ranks": ref_ranks,
                   "ours_ber_min": round(float(bers.min()), 6),
                   "ours_ber_median": round(float(np.median(bers)), 6),
                   "ours_ber_max": round(float(bers.max()), 6),
                   "grain": round(grain, 6), "pass": bool(ok)}
            out["grid"].append(row)
            print(f"{num_tx}x{num_rx} {det:5s} ref={ref_ber:.4f} "
                  f"ranks={ref_ranks} ours=[{bers.min():.4f}, "
                  f"{np.median(bers):.4f}, {bers.max():.4f}] "
                  f"{'OK' if ok else 'MISS'}", flush=True)
    out["all_pass"] = bool(all_pass)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results",
        "spatial_grid_validation.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("saved", path, "all_pass:", all_pass, flush=True)


if __name__ == "__main__":
    main()
