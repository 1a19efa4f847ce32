"""Distributed Monte-Carlo sweeps: every pipeline sharded over a device mesh.

The reference's only parallelism is a ThreadPoolExecutor over RX antennas
(/root/reference/core/ofdm_core.py:1615-1638) and sequential Python loops
over SNR points x trials (ofdm_core.py:1795-1846). Here a sweep is ONE XLA
program shard_map-ed over a jax.sharding.Mesh: frames shard across devices
(and optionally SNR points across a second mesh axis), bit-error counts
psum-reduce over the mesh, and the same code runs on one device, every GPU
of a host, or multi-host (parallel/distributed.initialize).

Run on whatever devices JAX finds (every GPU of the host, for example):
    python examples/example_sweep_distributed.py
or, on a machine without accelerators, on an 8-device virtual CPU mesh:
    python examples/example_sweep_distributed.py --virtual-cpu-mesh
"""
import os
import sys

if "--virtual-cpu-mesh" in sys.argv[1:]:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.parallel import sweep


def main():
    print(f"devices: {jax.device_count()} x {jax.devices()[0].platform}")
    key = jax.random.PRNGKey(0)

    # --- uncoded SISO sweep on a 1-D mesh: frames shard across devices ---
    cfg = LTEConfig(bandwidth=5.0, modulation="16-QAM")
    r = sweep.ber_sweep(key, cfg, snr_points=[6.0, 10.0, 14.0, 18.0],
                        frames_per_device=4, num_ofdm_symbols=28)
    print(f"\nSISO 16-QAM, {r.frames} frames/point "
          f"({jax.device_count()} devices):")
    for snr, ber in zip(np.asarray(r.snr_db), np.asarray(r.ber)):
        print(f"  SNR {snr:5.1f} dB -> BER {ber:.2e}")

    # --- 2-D (snr x mc) mesh: SNR points shard across devices too ---
    if jax.device_count() % 2 == 0:
        mesh2 = sweep.make_mesh_2d(num_snr_shards=2)
        r = sweep.ber_sweep(jax.random.fold_in(key, 1), cfg,
                            snr_points=[6.0, 10.0, 14.0, 18.0],
                            frames_per_device=4, num_ofdm_symbols=28,
                            mesh=mesh2)
        print(f"\nSame sweep on a 2-D {dict(mesh2.shape)} mesh:")
        for snr, ber in zip(np.asarray(r.snr_db), np.asarray(r.ber)):
            print(f"  SNR {snr:5.1f} dB -> BER {ber:.2e}")

    # --- full TS 36.212 coded chain as the sharded pipeline ---
    cfg5 = LTEConfig(bandwidth=5.0, modulation="QPSK")
    r = sweep.ber_sweep(jax.random.fold_in(key, 2), cfg5,
                        snr_points=[3.0, 4.0, 5.0],
                        frames_per_device=1, num_ofdm_symbols=28,
                        pipeline="coded", coded_tb_bits=1000)
    print(f"\nCoded chain (1000-bit TBs, {r.frames} TBs/point):")
    for snr, ber in zip(np.asarray(r.snr_db), np.asarray(r.ber)):
        print(f"  SNR {snr:5.1f} dB -> post-decode BER {ber:.2e}")

    # --- MIMO detector comparison at sweep scale (identical keys =>
    #     paired channels/noise). Note: MMSE here is the reference's
    #     BIASED solution hard-decided without bias compensation, so its
    #     ordering vs ZF is draw-dependent; SIC's cancellation gain is
    #     the stable ranking. ---
    cfgq = LTEConfig(bandwidth=1.25, modulation="QPSK")
    print("\nSpatial 2x2 rank-2 detector comparison (paired noise, QPSK):")
    for det in ("ZF", "MMSE", "SIC"):
        r = sweep.ber_sweep(jax.random.fold_in(key, 3), cfgq,
                            snr_points=[10.0], frames_per_device=2,
                            num_ofdm_symbols=14, pipeline="spatial",
                            num_tx=2, num_rx=2, detector_type=det, rank=2)
        print(f"  {det:>4}: BER {float(r.ber[0]):.2e}")

    # --- sharded in-graph HARQ: BLER per combined transmission ---
    rh = sweep.harq_sweep(jax.random.fold_in(key, 4), cfg5,
                          snr_points=[1.0, 2.5, 4.0],
                          frames_per_device=1, tb_bits=1000,
                          rv_sequence=(0, 1), num_iterations=4)
    print(f"\nHARQ chase combining (1000-bit TBs, {rh.frames} TBs/point, "
          f"rv schedule 0,1):")
    for i, snr in enumerate(np.asarray(rh.snr_db)):
        st = np.asarray(rh.bler_per_stage)[i]
        print(f"  SNR {snr:4.1f} dB -> BLER after 1 tx {st[0]:.2f}, "
              f"after 2 {st[1]:.2f}; mean tx "
              f"{float(rh.avg_transmissions[i]):.2f}")


if __name__ == "__main__":
    main()
