"""Measure the 8-TX CRS layout divergence at the reference's capstone shape.

Runs the 8x4 spatial-multiplexing workload of
/root/reference/test/test_spatial_multiplexing.py:44-49 (64-QAM, 10 MHz,
rayleigh_mp Ped-A, SNR 25 dB) under both pilot layouts (PARITY.md
divergence 9) x {MMSE, SIC} x {rank 2, rank 4, adaptive} and writes
results/spatial_8tx_extended.json — the grid-validation row for the
extended layout alongside the parity one (VERDICT r4 task 5).

CPU-friendly (BER only): JAX_PLATFORMS=cpu python
tools/probe_8tx_extended.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import spatial

    cfg = LTEConfig(bandwidth=10.0, modulation="64-QAM")
    lanes, S = 16, 2
    n = spatial.bits_per_frame(cfg, S)
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (lanes, n)).astype(np.int32))

    rows = []
    for layout in ("reference", "extended"):
        for det in ("MMSE", "SIC"):
            for rank in (2, 4, "adaptive"):
                t0 = time.perf_counter()
                r = spatial.simulate_spatial_multiplexing(
                    jax.random.PRNGKey(1), bits, 25.0, cfg,
                    num_tx=8, num_rx=4, rank=rank, detector_type=det,
                    channel_type="rayleigh_mp",
                    itu_profile="Pedestrian_A", velocity_kmh=3.0,
                    pilot_layout=layout)
                ber = np.asarray(r.ber)
                row = {
                    "layout": layout, "detector": det, "rank": str(rank),
                    "ber_median": float(np.median(ber)),
                    "ber_min": float(ber.min()),
                    "ber_max": float(ber.max()),
                    "wall_s": round(time.perf_counter() - t0, 1),
                }
                rows.append(row)
                print(row, flush=True)

    out = {
        "workload": "8x4 spatial 64-QAM 10 MHz rayleigh_mp Ped-A @25 dB "
                    f"({lanes} lanes x {S} symbols)",
        "reference_capstone": "/root/reference/test/"
                              "test_spatial_multiplexing.py:44-49",
        "measured": time.strftime("%Y-%m-%d"),
        "grid": rows,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "spatial_8tx_extended.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
