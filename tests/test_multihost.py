"""Multi-host (multi-process) distributed sweep: correctness (two
jax.distributed processes agree on the psum-reduced result) and scaling
throughput (per-process rate at 2 processes >= 85% of 1 process,
BASELINE.md's "N>=2 hosts" regime — measured by parallel.mp_bench with
per-core pinning and retry hardening)."""
import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_sweep():
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "multihost_worker.py")
    port = str(_free_port())
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)   # 1 device per process

    procs = [subprocess.Popen([sys.executable, worker, str(i), "2", port],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"WORKER_OK {i}" in out, out[-2000:]
    # both processes report the SAME psum-reduced BER
    v0 = [l for l in outs[0].splitlines() if l.startswith("WORKER_OK")][0]
    v1 = [l for l in outs[1].splitlines() if l.startswith("WORKER_OK")][0]
    assert v0.split()[2] == v1.split()[2]


# slow lane: the committed scaling artifact + test_two_process_distributed_sweep
# keep multi-process coverage in the default run
@pytest.mark.slow
def test_multiprocess_scaling_efficiency():
    """BASELINE.md:37 "N>=2 hosts" half of the >=85% scaling target: two
    core-pinned jax.distributed processes each sustain >=85% of the
    single-process per-process sweep rate. measure() retries up to 3x per
    count against container scheduling noise; the committed artifact
    results/scaling_efficiency_multihost.json is refreshed only by
    tools/measure_scaling.py — this test writes the untracked _local copy."""
    from ofdm_lte_tpu.parallel import mp_bench

    r = mp_bench.measure((1, 2))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results",
        "scaling_efficiency_multihost_local.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({str(n): {k: (round(v, 4) if isinstance(v, float)
                                else v) for k, v in d.items()}
                   for n, d in r.items()}, f, indent=2)
    assert r[2]["efficiency"] >= 0.85, r
