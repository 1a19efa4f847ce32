"""Coded-chain waterfall validation: BER + CRC-pass-rate vs SNR.

Measures, for the 6000-bit QPSK 5 MHz AWGN transport block (the BASELINE.md
coded workload, 8 decoder iterations):

- ours, max-log BCJR        (simulate_siso_coded_batched, many TBs/point)
- ours, exact Log-MAP       (use_max_log=False)
- reference NumPy           (simulate_siso_coded, fewer TBs - 6.8 s each)

across the turbo waterfall (~3-7 dB in this chain's SNR convention), so
VALIDATION.md can carry a real curve instead of two point anchors, and the
bench's crc_pass_fraction@5dB can be judged in-family against the
reference's own pass rate.

Writes tools/coded_waterfall.json incrementally. "ours"/"reference" force
the CPU backend in-process ('scan' BCJR, ensemble arbiter); "gpu" runs the
same ensemble on the GPU with its default 'block' BCJR kernel — the check
that the blocked-scan decomposition's float reassociation does not move
the waterfall (compare the gpu_maxlog rows against ours_maxlog within
binomial bounds); it exits nonzero without a GPU. Usage:
    python tools/coded_waterfall.py [ours|reference|both|gpu] [tbs] [tbs_ref]
"""
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
if (sys.argv[1:2] or ["both"])[0] != "gpu":
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp                                  # noqa: E402

SNRS = [3.0, 3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 7.0]
SNRS_GPU = [2.5, 3.0, 3.25, 3.5, 4.0, 5.0]
TB_BITS = 6000
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "coded_waterfall.json")

results = json.load(open(OUT)) if os.path.exists(OUT) else {}


def save():
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)


def ours(n_tbs=64, gpu=False):
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import coded

    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, (n_tbs, TB_BITS)).astype(np.int32))
    modes = ([("gpu_maxlog", True)] if gpu
             else [("ours_maxlog", True), ("ours_logmap", False)])
    for mode, uml in modes:
        entry = results.setdefault(mode, {})
        for snr in (SNRS_GPU if gpu else SNRS):
            k = f"{snr:g}"
            if k in entry:
                continue
            t0 = time.time()
            r = coded.simulate_siso_coded_batched(
                jax.random.PRNGKey(int(snr * 10)), bits,
                jnp.full((n_tbs,), snr, jnp.float32), cfg,
                use_max_log=uml)
            errs = int(jnp.sum(r.bit_errors))
            passes = int(jnp.sum(r.crc_pass.astype(jnp.int32)))
            entry[k] = {"ber": errs / (n_tbs * TB_BITS),
                        "crc_pass_rate": passes / n_tbs,
                        "n_tbs": n_tbs,
                        "wall_s": round(time.time() - t0, 1)}
            save()
            print(f"# {mode} snr={snr}: {entry[k]}", file=sys.stderr)


def reference(n_tbs=16):
    sys.path.insert(0, "/root/reference")
    from config import LTEConfig as RefConfig
    from core.ofdm_core import OFDMSimulator
    from core.channel_coding import turbo_decoder as ref_td

    rng = np.random.default_rng(0)
    cfg = RefConfig(bandwidth=5, modulation="QPSK")
    for mode, uml in (("ref_maxlog", True), ("ref_logmap", False)):
        ref_td.USE_MAX_LOG_MAP = uml
        entry = results.setdefault(mode, {})
        for snr in SNRS:
            k = f"{snr:g}"
            if k in entry:
                continue
            errs = passes = 0
            t0 = time.time()
            for t in range(n_tbs):
                bits = rng.integers(0, 2, TB_BITS).astype(int)
                with contextlib.redirect_stdout(io.StringIO()):
                    sim = OFDMSimulator(config=cfg, channel_type="awgn",
                                        mode="lte")
                    r = sim.simulate_siso_coded(bits, snr_db=snr)
                errs += int(r["bit_errors"])
                passes += int(bool(r["crc_pass"]))
            entry[k] = {"ber": errs / (n_tbs * TB_BITS),
                        "crc_pass_rate": passes / n_tbs,
                        "n_tbs": n_tbs,
                        "wall_s": round(time.time() - t0, 1)}
            save()
            print(f"# {mode} snr={snr}: {entry[k]}", file=sys.stderr)
    ref_td.USE_MAX_LOG_MAP = True


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    n_ours = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    n_ref = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    if which == "gpu":
        from ofdm_lte_tpu.utils.device import require_gpu
        require_gpu()
        ours(n_ours, gpu=True)
    if which in ("ours", "both"):
        ours(n_ours)
    if which in ("reference", "both"):
        reference(n_ref)
    print(json.dumps(results, indent=2))
