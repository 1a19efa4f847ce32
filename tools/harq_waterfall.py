"""HARQ waterfall: BLER after each combined transmission vs SNR.

Runs the in-graph HARQ schedule (sim.coded.simulate_siso_coded_harq_batched,
rv schedule 0,1,2,3, chase/IR combining) on the 6000-bit QPSK 5 MHz AWGN
transport block across the knee region and records BLER-per-stage and mean
transmissions. With E = 3K+12 every transmission carries the full circular
buffer, so combining doubles received energy per coded bit at stage 2
(~+3.0 dB), then +1.76 dB, +1.25 dB — the per-stage knee (SNR@BLER=0.5)
must shift left by >=1 dB per added transmission (VERDICT r2 task 4's
"done" gate).

CPU-only by default (forces the CPU backend in-process, ensemble mode);
`gpu` mode runs a spot-check batch on the GPU instead (same program,
'block' BCJR) and exits nonzero without one. Writes
tools/harq_waterfall.json incrementally.

Usage:
    python tools/harq_waterfall.py [cpu|gpu] [tbs_per_point]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TB_BITS = 6000
RV_SEQ = (0, 1, 2, 3)
SNRS_CPU = [-4.0, -3.0, -2.5, -2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0,
            1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5]
SNRS_GPU = [-2.0, 0.0, 2.0, 3.5]
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "harq_waterfall.json")


def knee(snrs, blers, level=0.5):
    """Linear-interpolated SNR where BLER crosses `level` (descending)."""
    s = np.asarray(snrs, float)
    b = np.asarray(blers, float)
    for i in range(len(s) - 1):
        if b[i] >= level > b[i + 1]:
            f = (b[i] - level) / max(b[i] - b[i + 1], 1e-12)
            return float(s[i] + f * (s[i + 1] - s[i]))
    return None


def run(mode="cpu", n_tbs=64):
    import jax
    if mode == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        from ofdm_lte_tpu.utils.device import require_gpu
        require_gpu()
    import jax.numpy as jnp
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import coded

    results = json.load(open(OUT)) if os.path.exists(OUT) else {}
    tag = f"{mode}_maxlog_{n_tbs}tbs"
    entry = results.setdefault(tag, {})
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    rng = np.random.default_rng(0)
    bits = jnp.asarray(rng.integers(0, 2, (n_tbs, TB_BITS)).astype(np.int32))
    snrs = SNRS_CPU if mode == "cpu" else SNRS_GPU

    for snr in snrs:
        k = f"{snr:g}"
        if k in entry:
            continue
        t0 = time.time()
        r = coded.simulate_siso_coded_harq_batched(
            jax.random.PRNGKey(int(snr * 10) + 100), bits,
            jnp.full((n_tbs,), snr, jnp.float32), cfg, rv_sequence=RV_SEQ)
        stage = np.asarray(r.crc_pass_stage)           # (n_tbs, 4)
        entry[k] = {
            "bler_per_stage": [round(float(np.mean(~stage[:, t])), 4)
                               for t in range(len(RV_SEQ))],
            "avg_transmissions": round(
                float(np.mean(np.asarray(r.num_transmissions))), 3),
            "residual_ber": round(
                int(np.sum(np.asarray(r.bit_errors))) / (n_tbs * TB_BITS),
                6),
            "n_tbs": n_tbs,
            "wall_s": round(time.time() - t0, 1),
        }
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(f"# {tag} snr={snr}: {entry[k]}", file=sys.stderr, flush=True)

    # per-stage knees + gains
    snr_sorted = sorted(float(s) for s in entry)
    knees = []
    for t in range(len(RV_SEQ)):
        blers = [entry[f"{s:g}"]["bler_per_stage"][t] for s in snr_sorted]
        knees.append(knee(snr_sorted, blers))
    gains = [round(knees[t] - knees[t + 1], 2)
             if knees[t] is not None and knees[t + 1] is not None else None
             for t in range(len(knees) - 1)]
    results[f"{tag}_knees"] = {
        "snr_at_bler50_per_stage": [None if x is None else round(x, 2)
                                    for x in knees],
        "gain_db_per_added_tx": gains,
    }
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({tag: results[f"{tag}_knees"]}, indent=2))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    n_tbs = int(sys.argv[2]) if len(sys.argv) > 2 else (
        64 if mode == "cpu" else 32)
    run(mode, n_tbs)
