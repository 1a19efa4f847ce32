"""Worker for the multi-process distributed sweep test (run by
test_multihost.py, one process per fake host)."""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from jax.experimental import multihost_utils

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.parallel import distributed, sweep


def main():
    pid = int(sys.argv[1])
    n = int(sys.argv[2])
    port = sys.argv[3]
    distributed.initialize(f"127.0.0.1:{port}", num_processes=n,
                           process_id=pid)
    mesh = distributed.global_mesh()
    assert len(mesh.devices.flat) == n

    cfg = LTEConfig(bandwidth=1.25, modulation="QPSK")
    r = sweep.ber_sweep(jax.random.PRNGKey(0), cfg, [6.0, 60.0],
                        frames_per_device=1, num_ofdm_symbols=14, mesh=mesh)
    ber = np.asarray(multihost_utils.process_allgather(r.ber, tiled=True))
    flat = ber.reshape(-1)
    assert flat[1] == 0.0, flat
    assert 0.0 < flat[0] < 0.1, flat
    print(f"WORKER_OK {pid} {flat[0]:.6f}", flush=True)


if __name__ == "__main__":
    main()
