"""Basic SISO OFDM example: QPSK, 1.25 MHz (128-pt FFT), AWGN BER sweep.

The JAX equivalent of the reference's examples/example_basic.py
workload (BASELINE.json config #1).

Run: python examples/example_basic.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.api import OFDMModule
from ofdm_lte_tpu.parallel import sweep


def main():
    config = LTEConfig(bandwidth=1.25, delta_f=15.0, modulation="QPSK")
    print(config.get_info())

    # --- single transmission through the object API ---
    module = OFDMModule(config)
    bits = np.random.default_rng(0).integers(0, 2, 50_000)
    result = module.transmit(bits, snr_db=8.0)
    print(f"\nSingle run @8 dB: BER={result['ber']:.4f} "
          f"PAPR={result['papr_db']:.2f} dB")

    # --- sharded Monte-Carlo BER sweep (one XLA program, all devices) ---
    r = sweep.ber_sweep(jax.random.PRNGKey(0), config,
                        snr_points=np.arange(0, 13, 2.0),
                        frames_per_device=8, num_ofdm_symbols=28)
    print(f"\nBER sweep over {r.frames} frames/point:")
    for snr, ber in zip(np.asarray(r.snr_db), np.asarray(r.ber)):
        print(f"  SNR {snr:5.1f} dB -> BER {ber:.2e}")


if __name__ == "__main__":
    main()
