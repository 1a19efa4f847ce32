"""Benchmark: simulated LTE frames per second on one NVIDIA GPU.

Prints ONE JSON line for the headline workload (20 MHz 64-QAM end-to-end
SISO link) as soon as it is measured, then runs the secondary entries and
rewrites BENCH_DETAILS.json after each one.

Every entry compiles its step once (compile seconds are reported apart),
runs it once to warm up, then times `n_steps` steps chained through one
jitted lax.scan (each step's key depends on the previous step's result, so
the steps cannot overlap) and ends the window in block_until_ready. A frame
is one 14-symbol LTE subframe. The lane counts are not yet tuned on the
card (ROADMAP 1.9).

The vs-reference denominators are the reference NumPy simulator's CPU
rates (BASELINE.md "Measured on this machine"), kept as frozen constants.

    python bench.py                  # headline + every entry
    python bench.py --only-siso      # the headline only
    python bench.py --entries=a,b    # only the named entries

Exits nonzero without a GPU, and when any entry fails.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

# Frozen reference-CPU denominators (BASELINE.md; the reference simulator
# is no longer available to re-measure them).
REF_SISO_FPS = 4.135       # 20 MHz 64-QAM AWGN
REF_SPATIAL_FPS = 1.965    # 20 MHz 64-QAM 2x2 rank-2 MMSE
REF_SCFDM_FPS = 17.604     # 5 MHz 16-QAM SC-FDM AWGN
REF_SIMO_FPS = 8.798       # 5 MHz QPSK 1x4 Rayleigh Ped-A
REF_CODED_TBPS = 0.147     # 6000-bit TB, QPSK 5 MHz @5 dB, 8 iterations
# (the reference's 2x1 Alamouti path crashes as-shipped — no denominator)

LANES = 256
SPATIAL_LANES = 1024
DIVERSITY_LANES = 512
NUM_SYMBOLS = 14

_DETAILS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_DETAILS.json")
_details = {}
_failed = []


def _record(name, value):
    """Add one entry and rewrite BENCH_DETAILS.json at once, so a cut run
    keeps every entry it finished."""
    _details[name] = value
    with open(_DETAILS_PATH, "w") as f:
        json.dump(_details, f, indent=2)


def _run_entry(name, fn, only=None):
    """Run one secondary entry; a failure is recorded and fails the run."""
    if only is not None and name not in only:
        return
    try:
        _record(name, fn())
    except Exception as e:
        _failed.append(name)
        _record(name, {"error": f"{type(e).__name__}: {str(e)[:300]}"})
        print(f"# entry {name} failed: {e}", file=sys.stderr)


def _time_steps(fn, key, n_steps=20):
    """(seconds per step, compile seconds) of `fn(key)` chained n_steps
    times inside one jitted lax.scan; fn returns integer-reducible
    outputs."""
    def run(key):
        def body(carry, i):
            out = fn(jax.random.fold_in(key, i + carry))
            total = sum(jnp.sum(o).astype(jnp.int32)
                        for o in jax.tree.leaves(out))
            return total, None
        return jax.lax.scan(body, jnp.int32(0), jnp.arange(n_steps))[0]

    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(key).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(key))                 # warm-up
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(jax.random.fold_in(key, 1)))
    return (time.perf_counter() - t0) / n_steps, compile_s


def _rate(lanes, dt, compile_s, unit="frames_per_s", **extra):
    return {unit: round(lanes / dt, 2), "step_ms": round(dt * 1e3, 3),
            "compile_s": round(compile_s, 2), "lanes": lanes, **extra}


def _bits(lanes, n_bits):
    # int8 bits: 1 B/bit of traffic through map/demap/error-count (the
    # sims follow the caller's dtype; see sim/siso.py)
    return jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (lanes, n_bits)).astype(np.int8))


def bench_siso(cfg, snr_db=15.0, lanes=LANES):
    """(frames/s, BER at snr_db, step s, compile s) of the SISO link."""
    from ofdm_lte_tpu.sim import siso

    bits = _bits(lanes, siso.bits_per_frame(cfg, NUM_SYMBOLS))
    snr = jnp.full((lanes,), snr_db, jnp.float32)

    def step(key):
        r = siso.simulate_siso(key, bits, snr, cfg)
        return r.bit_errors, r.papr_db

    dt, compile_s = _time_steps(step, jax.random.PRNGKey(0))
    r = siso.simulate_siso(jax.random.PRNGKey(7), bits, snr, cfg)
    ber = float(jnp.sum(r.bit_errors)) / bits.size
    return lanes / dt, ber, dt, compile_s


def _spatial(cfg, lanes, snr_db, **kw):
    from ofdm_lte_tpu.sim import spatial

    bits = _bits(lanes, spatial.bits_per_frame(cfg, NUM_SYMBOLS))
    snr = jnp.full((lanes,), snr_db, jnp.float32)

    def step(key):
        return spatial.simulate_spatial_multiplexing(
            key, bits, snr, cfg, **kw).bit_errors

    return _time_steps(step, jax.random.PRNGKey(0), n_steps=10)


def bench_spatial(cfg, lanes=SPATIAL_LANES):
    dt, c = _spatial(cfg, lanes, 15.0, num_tx=2, num_rx=2, rank=2,
                     detector_type="MMSE")
    return _rate(lanes, dt, c,
                 vs_reference_cpu=round(lanes / dt / REF_SPATIAL_FPS, 2))


def bench_spatial_4x4(cfg, lanes=512):
    """4x4 rank-4 MMSE through the block-Schur plane solve
    (mimo.detector.mmse4_planes); the reference's capstone grid names this
    shape (/root/reference/test/test_spatial_multiplexing.py:229-237)."""
    dt, c = _spatial(cfg, lanes, 25.0, num_tx=4, num_rx=4, rank=4,
                     detector_type="MMSE")
    return _rate(lanes, dt, c)


def bench_spatial_sic_4x4(cfg, lanes=512):
    """4x4 rank-4 SIC through the plane SIC (mimo.detector.sic_planes)."""
    dt, c = _spatial(cfg, lanes, 25.0, num_tx=4, num_rx=4, rank=4,
                     detector_type="SIC")
    return _rate(lanes, dt, c)


def bench_spatial_mp(cfg, lanes=256):
    """2x2 spatial multiplexing over the multipath (rayleigh_mp) channel —
    the time-domain path with per-link Jakes fading
    (ofdm_core.py:2489-2816 + channel.py:397-493)."""
    dt, c = _spatial(cfg, lanes, 25.0, num_tx=2, num_rx=2, rank=2,
                     detector_type="MMSE", channel_type="rayleigh_mp",
                     itu_profile="Pedestrian_A", velocity_kmh=3.0)
    return _rate(lanes, dt, c,
                 vs_reference_cpu=round(lanes / dt / REF_SPATIAL_FPS, 2))


def bench_beamforming(lanes=1024):
    """TM6 codebook beamforming 4x2 on the flat MIMO channel (the
    reference's frequency-domain path, ofdm_core.py:2260-2477), static and
    with adaptive Jakes evolution at 120 km/h (per-symbol channel + cadenced
    precoder recompute)."""
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.config import doppler_hz
    from ofdm_lte_tpu.mimo.beamforming import update_period_symbols
    from ofdm_lte_tpu.sim import beamforming as bfs

    cfg = LTEConfig(bandwidth=10.0, modulation="64-QAM")
    bits = _bits(lanes, bfs.bits_per_frame(cfg, NUM_SYMBOLS))
    snr = jnp.full((lanes,), 15.0, jnp.float32)

    def step(key):
        return bfs.simulate_beamforming(key, bits, snr, cfg, num_tx=4,
                                        num_rx=2).bit_errors

    out = {"static": _rate(lanes, *_time_steps(
        step, jax.random.PRNGKey(0), n_steps=10))}
    period, fd = update_period_symbols(120.0), doppler_hz(120.0, 2.0)

    def step_jakes(key):
        return bfs.simulate_beamforming_time_varying(
            key, bits, snr, cfg, num_tx=4, num_rx=2,
            update_period=period, doppler_hz=fd).bit_errors

    out["adaptive_jakes_120kmh"] = _rate(lanes, *_time_steps(
        step_jakes, jax.random.PRNGKey(1), n_steps=10))
    return out


def bench_scfdm(lanes=LANES):
    """SISO uplink SC-FDM, 16-QAM, 5 MHz, AWGN."""
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import siso

    cfg = LTEConfig(bandwidth=5.0, modulation="16-QAM")
    bits = _bits(lanes, siso.bits_per_frame(cfg, NUM_SYMBOLS, "sc-fdm"))
    snr = jnp.full((lanes,), 15.0, jnp.float32)

    def step(key):
        return siso.simulate_siso(key, bits, snr, cfg,
                                  mode="sc-fdm").bit_errors

    dt, c = _time_steps(step, jax.random.PRNGKey(0))
    return _rate(lanes, dt, c,
                 vs_reference_cpu=round(lanes / dt / REF_SCFDM_FPS, 2))


def _fading_sim(kind):
    """(config, bits per frame, sim(key, bits, snr, cfg)) of the SIMO 1x4
    MRC (5 MHz QPSK) or SFBC 2x1 (10 MHz 16-QAM) Rayleigh Ped-A chain."""
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import diversity, siso

    fading = dict(channel_type="rayleigh_mp", itu_profile="Pedestrian_A",
                  velocity_kmh=3.0)
    if kind == "simo":
        cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
        return cfg, siso.bits_per_frame(cfg, NUM_SYMBOLS), (
            lambda k, b, s, c: diversity.simulate_simo(
                k, b, s, c, num_rx=4, **fading))
    cfg = LTEConfig(bandwidth=10.0, modulation="16-QAM")
    return cfg, diversity.sfbc_bits_per_frame(cfg, NUM_SYMBOLS), (
        lambda k, b, s, c: diversity.simulate_sfbc(
            k, b, s, c, num_rx=1, **fading))


def bench_fading(kind, lanes=DIVERSITY_LANES, chunk=None):
    """SIMO 1x4 / SFBC 2x1 over Jakes Rayleigh fading, flat or as unrolled
    lane chunks (parallel.chunking.lane_chunked), with the channel-FIR
    roofline against the card's published peaks."""
    from ofdm_lte_tpu.parallel.chunking import lane_chunked
    from ofdm_lte_tpu.precision import matmul_precision_name
    from ofdm_lte_tpu.utils import profiling

    cfg, n_bits, sim = _fading_sim(kind)
    if chunk:
        sim = lane_chunked(sim, chunk, mode="unroll")
    bits = _bits(lanes, n_bits)
    snr = jnp.full((lanes,), 10.0 if kind == "simo" else 15.0, jnp.float32)

    def step(key):
        return sim(key, bits, snr, cfg).bit_errors

    dt, c = _time_steps(step, jax.random.PRNGKey(0), n_steps=10)
    out = _rate(lanes, dt, c, chunk=chunk)
    if kind == "simo":
        out["vs_reference_cpu"] = round(lanes / dt / REF_SIMO_FPS, 2)
    if not chunk:
        precision = matmul_precision_name()
        cost = (profiling.simo_frame_cost(cfg, NUM_SYMBOLS, lanes, num_rx=4,
                                          precision=precision)
                if kind == "simo" else
                profiling.sfbc_frame_cost(cfg, NUM_SYMBOLS, lanes, num_rx=1,
                                          precision=precision))
        out["roofline"] = _rounded(profiling.fir_roofline_report(
            cost, dt, jax.devices()[0].device_kind, precision))
    return out


def bench_coded():
    """Host-orchestrated coded chain: one 6000-bit transport block, QPSK
    5 MHz AWGN @5 dB, 8 decoder iterations (BASELINE.md's coded workload).
    Host orchestration syncs every call, so this is serialized wall-clock."""
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.sim import coded

    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    bits = np.random.default_rng(0).integers(0, 2, 6000).astype(np.int32)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    r = coded.simulate_siso_coded(key, bits, 5.0, cfg)   # compile + warm-up
    compile_s = time.perf_counter() - t0
    assert r.crc_pass
    n = 5
    t0 = time.perf_counter()
    for i in range(n):
        r = coded.simulate_siso_coded(jax.random.fold_in(key, i), bits,
                                      5.0, cfg)
    dt = (time.perf_counter() - t0) / n
    return {"transport_blocks_per_s": round(1.0 / dt, 3),
            "vs_reference_cpu": round(1.0 / dt / REF_CODED_TBPS, 1),
            "compile_s": round(compile_s, 2), "crc_pass": bool(r.crc_pass)}


def bench_coded_batched(lanes=128, chunk=None):
    """Batched in-graph coded chain: `lanes` 6000-bit transport blocks (QPSK
    5 MHz AWGN @5 dB, 8 decoder iterations) as lanes of one program,
    flat or as sequential lax.map chunks."""
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.parallel.chunking import lane_chunked
    from ofdm_lte_tpu.sim import coded

    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    bits = jnp.asarray(np.random.default_rng(0).integers(
        0, 2, (lanes, 6000)).astype(np.int32))
    snr = jnp.full((lanes,), 5.0, jnp.float32)
    sim = coded.simulate_siso_coded_batched
    if chunk:
        sim = lane_chunked(sim, chunk, mode="scan")

    def step(key):
        r = sim(key, bits, snr, cfg)
        return r.bit_errors, r.crc_pass

    dt, c = _time_steps(step, jax.random.PRNGKey(0), n_steps=5)
    r = sim(jax.random.PRNGKey(7), bits, snr, cfg)
    return _rate(lanes, dt, c, unit="transport_blocks_per_s", chunk=chunk,
                 vs_reference_cpu=round(lanes / dt / REF_CODED_TBPS, 1),
                 crc_pass_fraction=float(jnp.mean(
                     r.crc_pass.astype(jnp.float32))))


def bench_sweep_wall_clock(cfg):
    """Wall-clock of a sharded Monte-Carlo BER sweep (5 SNR points x 8
    frames x 14 symbols) through parallel.sweep.ber_sweep."""
    from ofdm_lte_tpu.parallel import sweep

    snrs = [5.0, 10.0, 15.0, 20.0, 25.0]
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    r = sweep.ber_sweep(key, cfg, snrs, frames_per_device=8,
                        num_ofdm_symbols=NUM_SYMBOLS)
    jax.block_until_ready(r.ber)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = sweep.ber_sweep(jax.random.fold_in(key, 1), cfg, snrs,
                        frames_per_device=8, num_ofdm_symbols=NUM_SYMBOLS)
    jax.block_until_ready(r.ber)
    return {"seconds": round(time.perf_counter() - t0, 3),
            "first_call_s": round(first_s, 3), "snr_points": 5,
            "frames": r.frames * 5}


def bench_batch_scaling(cfg):
    """Frames/s of the SISO headline at 64 lanes against LANES lanes."""
    out = {}
    for lanes in (64, LANES):
        fps, _, dt, c = bench_siso(cfg, lanes=lanes)
        out[f"lanes_{lanes}"] = _rate(lanes, dt, c,
                                      per_lane=round(fps / lanes, 2))
    out["throughput_gain"] = round(
        out[f"lanes_{LANES}"]["frames_per_s"]
        / out["lanes_64"]["frames_per_s"], 3)
    return out


def _rounded(d):
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def _siso_entry(cfg, precision):
    """The SISO headline at matmul precision `precision`, traced afresh
    (the precision is read at trace time)."""
    from ofdm_lte_tpu.utils.profiling import roofline_report
    prev = os.environ.get("OFDM_LTE_TPU_MATMUL_PRECISION")
    os.environ["OFDM_LTE_TPU_MATMUL_PRECISION"] = precision
    jax.clear_caches()
    try:
        fps, ber, dt, c = bench_siso(cfg)
    finally:
        if prev is None:
            os.environ.pop("OFDM_LTE_TPU_MATMUL_PRECISION", None)
        else:
            os.environ["OFDM_LTE_TPU_MATMUL_PRECISION"] = prev
        jax.clear_caches()
    return _rate(LANES, dt, c, precision=precision, ber_at_15db=ber,
                 vs_reference_cpu=round(fps / REF_SISO_FPS, 2),
                 roofline=_rounded(roofline_report(
                     cfg, NUM_SYMBOLS, LANES, dt,
                     jax.devices()[0].device_kind, precision=precision)))


def main():
    from ofdm_lte_tpu import LTEConfig
    from ofdm_lte_tpu.precision import matmul_precision_name
    from ofdm_lte_tpu.utils.device import (enable_compile_cache,
                                           gpu_name_and_power_limit,
                                           require_gpu)

    dev = require_gpu()
    enable_compile_cache()
    only = None
    for a in sys.argv[1:]:
        if a.startswith("--entries="):
            only = set(a.split("=", 1)[1].split(","))
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()),
              "name_power_limit": gpu_name_and_power_limit()}
    print(f"# device: {device}", file=sys.stderr, flush=True)
    _record("device", device)

    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    precision = matmul_precision_name()

    if only is None or "siso_20MHz_64QAM" in only:
        head = _siso_entry(cfg, precision)
        print(json.dumps({
            "metric": "ofdm_frames_per_s_20MHz_64QAM_siso",
            "value": head["frames_per_s"], "unit": "frames/s",
            "vs_baseline": head["vs_reference_cpu"],
            "precision": precision, "device": device}), flush=True)
        _record("siso_20MHz_64QAM", head)
        if "--only-siso" in sys.argv:
            return 0

    alt = "highest" if precision != "highest" else "default"
    _run_entry(f"siso_20MHz_64QAM_{alt}_precision",
               lambda: _siso_entry(cfg, alt), only)
    a = _details.get("siso_20MHz_64QAM", {})
    b = _details.get(f"siso_20MHz_64QAM_{alt}_precision", {})
    if "ber_at_15db" in a and "ber_at_15db" in b:
        # identical bits and keys; only matmul rounding differs
        delta = abs(a["ber_at_15db"] - b["ber_at_15db"])
        _record("precision_parity", {
            precision: a["ber_at_15db"], alt: b["ber_at_15db"],
            "abs_delta": delta,
            "parity_ok": bool(delta < 0.02 * max(a["ber_at_15db"], 1e-6))})

    _run_entry("sfbc_2x1_rayleigh_10MHz_16QAM",
               lambda: bench_fading("sfbc"), only)
    _run_entry("sfbc_2x1_chunked_1024_10MHz_16QAM",
               lambda: bench_fading("sfbc", lanes=1024, chunk=256), only)
    _run_entry("simo_1x4_rayleigh_5MHz_QPSK",
               lambda: bench_fading("simo"), only)
    _run_entry("simo_1x4_chunked_1024_5MHz_QPSK",
               lambda: bench_fading("simo", lanes=1024, chunk=256), only)
    _run_entry("coded_batched_5MHz_QPSK_6000bit_TB",
               bench_coded_batched, only)
    _run_entry("coded_chunked_256_5MHz_QPSK_6000bit_TB",
               lambda: bench_coded_batched(lanes=256, chunk=128), only)

    def spatial_entry():
        from ofdm_lte_tpu.utils.profiling import spatial_roofline_report
        out = bench_spatial(cfg)
        out["roofline"] = _rounded(spatial_roofline_report(
            cfg, NUM_SYMBOLS, SPATIAL_LANES, out["step_ms"] / 1e3,
            jax.devices()[0].device_kind, precision=precision))
        return out

    _run_entry("spatial_2x2_20MHz_64QAM", spatial_entry, only)
    _run_entry("spatial_4x4_20MHz_64QAM", lambda: bench_spatial_4x4(cfg),
               only)
    _run_entry("spatial_sic_4x4_20MHz_64QAM",
               lambda: bench_spatial_sic_4x4(cfg), only)
    _run_entry("spatial_2x2_rayleigh_mp_20MHz_64QAM",
               lambda: bench_spatial_mp(cfg), only)
    _run_entry("beamforming_4x2_10MHz_64QAM", bench_beamforming, only)
    _run_entry("coded_5MHz_QPSK_6000bit_TB", bench_coded, only)
    _run_entry("scfdm_siso_5MHz_16QAM", bench_scfdm, only)
    _run_entry("ber_sweep_wall_clock", lambda: bench_sweep_wall_clock(cfg),
               only)
    _run_entry("siso_batch_scaling", lambda: bench_batch_scaling(cfg), only)

    if _failed:
        print(f"# failed entries: {_failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
