"""Smoke test of the LTE link simulator on NVIDIA GPUs, through the entry
points users call, at full LTE width.

    python chip_smoke.py           # phases a-f on one card
    python chip_smoke.py --multi   # the sharded sweeps on four cards, only

Phases (one card):
  a  modem (20 MHz, 3584 OFDM symbols) against a float64 numpy.fft
     reference, at matmul precision `highest` and `default`;
  b  SISO 20 MHz 64-QAM AWGN sweep, 1024 frames per SNR point;
  c  spatial multiplexing: 2x2 rank-2 MMSE and 4x4 rank-4 SIC, 20 MHz;
  d  Jakes Rayleigh fading at 10 MHz: SIMO 1x4 against 1x1, SFBC 2x1;
  e  coded chain (6000-bit TB, 5 MHz QPSK) and HARQ, plus the two BCJR
     kernels on identical K=6144 LLRs;
  f  the CLI's sweep command, in this process.
Each sweep phase re-runs a subset of its lanes, with the same PRNG keys
and bits, on the CPU and bounds the difference in bit errors.

Each phase prints one line with its results, compile seconds and the
jitted step's memory analysis. The last line of standard output is one
JSON object naming the device; it is printed only when every phase passed.
The script exits nonzero, with no result line, when JAX's first device is
not a GPU or when any phase fails.
"""
import argparse
import contextlib
import io
import json
import math
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from ofdm_lte_tpu import LTEConfig
from ofdm_lte_tpu.parallel import sweep
from ofdm_lte_tpu.utils.device import (enable_compile_cache,
                                       gpu_name_and_power_limit, require_gpu)

PRECISION_ENV = "OFDM_LTE_TPU_MATMUL_PRECISION"
NUM_SYMBOLS = 14
CROSS_LANES = 64          # lanes re-run on the CPU per cross-backend check


def check_device():
    """JAX's first device, which must be a GPU (SystemExit otherwise)."""
    return require_gpu()


@contextlib.contextmanager
def matmul_precision(name):
    """Trace everything inside at matmul precision `name`."""
    prev = os.environ.get(PRECISION_ENV)
    os.environ[PRECISION_ENV] = name
    jax.clear_caches()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(PRECISION_ENV, None)
        else:
            os.environ[PRECISION_ENV] = prev
        jax.clear_caches()


def check(ok, detail) -> None:
    """A phase's pass condition; unlike assert it survives python -O."""
    if not ok:
        raise AssertionError(detail)


def memory(stats) -> str:
    return (f"arg={stats.argument_size_in_bytes} "
            f"out={stats.output_size_in_bytes} "
            f"temp={stats.temp_size_in_bytes}")


def report(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def binomial_bound(ber: float, n_trials: int) -> float:
    """3 sigma of the difference of two independent binomial estimates of
    `ber`, each over `n_trials` trials."""
    return 3.0 * math.sqrt(2.0 * ber * (1.0 - ber) / n_trials)


def cross_backend(key, cfg, snr_points, frames, snr_index, precision,
                  lanes=CROSS_LANES, **sweep_kw):
    """Re-run `lanes` lanes of SNR point `snr_index` of a one-device
    ber_sweep (same key, frames and keyword arguments) on the GPU and on
    the CPU, with identical threefry keys and bits. Returns a dict of both
    error counts, the bit count, and the GPU step's compile seconds and
    memory analysis. `precision` picks the bound: `highest` allows
    max(5, 1e-3·errors) differing bits, anything else the binomial
    3-sigma bound on the BER difference."""
    kw = dict(mode="lte", channel_type="awgn", itu_profile="Pedestrian_A",
              velocity_kmh=None, pipeline="siso", num_tx=2, num_rx=2,
              detector_type="MMSE", rank=None)
    kw.update(sweep_kw)
    coded_tb_bits = kw.pop("coded_tb_bits", 6000)
    n_bits = sweep.bits_per_frame(cfg, NUM_SYMBOLS, kw["mode"],
                                  kw["pipeline"], coded_tb_bits)
    S = len(snr_points)
    keys, bits = jax.jit(sweep.lane_inputs, static_argnums=(2, 3, 4))(
        key, 0, S, frames, n_bits)
    k = np.asarray(keys[snr_index, :lanes])
    b = np.asarray(bits[snr_index, :lanes])
    del keys, bits
    snr = np.float32(snr_points[snr_index])

    def lanes_fn(k, b, snr):
        return jax.vmap(lambda kk, bb: sweep.run_lane(
            kk, bb, snr, cfg, kw["mode"], kw["channel_type"],
            kw["itu_profile"], kw["velocity_kmh"], kw["pipeline"],
            kw["num_tx"], kw["num_rx"], kw["detector_type"],
            kw["rank"])[0])(k, b)

    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    args_gpu = [jax.device_put(x, gpu) for x in (k, b, snr)]
    t0 = time.perf_counter()
    compiled = jax.jit(lanes_fn).lower(*args_gpu).compile()
    compile_s = time.perf_counter() - t0
    e_gpu = int(np.sum(np.asarray(compiled(*args_gpu), np.int64)))
    args_cpu = [jax.device_put(x, cpu) for x in (k, b, snr)]
    e_cpu = int(np.sum(np.asarray(jax.jit(lanes_fn)(*args_cpu), np.int64)))
    total = lanes * n_bits
    if precision == "highest":
        bound = max(5.0, 1e-3 * max(e_gpu, e_cpu))
        diff = abs(e_gpu - e_cpu)
    else:
        bound = binomial_bound(max(e_gpu, e_cpu) / total, total)
        diff = abs(e_gpu - e_cpu) / total
    check(diff <= bound, f"GPU {e_gpu} vs CPU {e_cpu} bit errors over "
          f"{total} bits ({precision}): {diff} > {bound}")
    return {"gpu_errors": e_gpu, "cpu_errors": e_cpu, "bits": total,
            "diff": diff, "bound": bound, "compile_s": round(compile_s, 2),
            "memory": memory(compiled.memory_analysis())}


def timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def phase_a_modem():
    from ofdm_lte_tpu.ops.ofdm_reference import modem_errors
    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    limits = {"highest": 1e-5, "default": 3e-3}
    for prec, limit in limits.items():
        with matmul_precision(prec):
            r = modem_errors(cfg, 256 * NUM_SYMBOLS)
        report("a", precision=prec, mod_rel_rms=r["modulate"],
               demod_rel_rms=r["demodulate"], limit=limit,
               compile_s=round(r["modulate_compile_s"]
                               + r["demodulate_compile_s"], 2),
               memory=memory(r["modulate_memory"]))
        check(r["modulate"] <= limit and r["demodulate"] <= limit, r)


def phase_b_siso():
    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    snrs = [10.0, 15.0, 20.0, 25.0, 60.0]
    frames = 1024
    key = jax.random.PRNGKey(11)
    for prec in ("highest", "default"):
        with matmul_precision(prec):
            r, dt = timed(sweep.ber_sweep, key, cfg, snrs,
                          frames_per_device=frames,
                          num_ofdm_symbols=NUM_SYMBOLS)
            ber = np.asarray(r.ber)
            xb = cross_backend(key, cfg, snrs, frames, snrs.index(20.0),
                               prec)
        report("b", precision=prec, ber=ber.tolist(), frames=r.frames,
               sweep_s=round(dt, 2), cross_20dB=xb)
        check(ber.shape == (5,) and np.all(np.isfinite(ber)), ber)
        check(ber[-1] == 0.0, ber)
        check(np.all(np.diff(ber[:4]) < 0), ber)


def phase_c_spatial():
    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    snrs = [15.0, 20.0, 30.0]
    frames = 256
    key = jax.random.PRNGKey(12)
    kw = dict(pipeline="spatial", num_tx=2, num_rx=2, rank=2,
              detector_type="MMSE")
    for prec in ("highest", "default"):
        with matmul_precision(prec):
            r, dt = timed(sweep.ber_sweep, key, cfg, snrs,
                          frames_per_device=frames,
                          num_ofdm_symbols=NUM_SYMBOLS, **kw)
            ber = np.asarray(r.ber)
            xb = cross_backend(key, cfg, snrs, frames, 1, prec, **kw)
        report("c", mimo="2x2 MMSE", precision=prec, ber=ber.tolist(),
               sweep_s=round(dt, 2), cross_20dB=xb)
        check(np.all(np.isfinite(ber)) and ber[0] > ber[-1], ber)
    r, dt = timed(sweep.ber_sweep, jax.random.PRNGKey(13), cfg, [25.0],
                  frames_per_device=frames, num_ofdm_symbols=NUM_SYMBOLS,
                  pipeline="spatial", num_tx=4, num_rx=4, rank=4,
                  detector_type="SIC")
    ber = float(np.asarray(r.ber)[0])
    report("c", mimo="4x4 SIC", ber_25dB=ber, sweep_s=round(dt, 2))
    check(math.isfinite(ber) and ber < 0.5, ber)


def phase_d_fading():
    cfg = LTEConfig(bandwidth=10.0, modulation="QPSK")
    fading = dict(channel_type="rayleigh_mp", itu_profile="Pedestrian_A",
                  velocity_kmh=3.0)
    frames = 256
    key = jax.random.PRNGKey(14)
    bers = {}
    for n_rx in (1, 4):
        r, dt = timed(sweep.ber_sweep, key, cfg, [10.0],
                      frames_per_device=frames, num_ofdm_symbols=NUM_SYMBOLS,
                      pipeline="simo", num_rx=n_rx, **fading)
        bers[n_rx] = float(np.asarray(r.ber)[0])
        xb = cross_backend(key, cfg, [10.0], frames, 0, "default",
                           lanes=16, pipeline="simo", num_rx=n_rx, **fading)
        report("d", pipeline=f"simo 1x{n_rx}", ber_10dB=bers[n_rx],
               sweep_s=round(dt, 2), cross=xb)
    check(bers[4] < bers[1], bers)

    cfg16 = LTEConfig(bandwidth=10.0, modulation="16-QAM")
    r, dt = timed(sweep.ber_sweep, key, cfg16, [15.0],
                  frames_per_device=frames, num_ofdm_symbols=NUM_SYMBOLS,
                  pipeline="sfbc", num_rx=1, **fading)
    ber = float(np.asarray(r.ber)[0])
    xb = cross_backend(key, cfg16, [15.0], frames, 0, "default", lanes=16,
                       pipeline="sfbc", num_rx=1, **fading)
    report("d", pipeline="sfbc 2x1", ber_15dB=ber, sweep_s=round(dt, 2),
           cross=xb)
    check(math.isfinite(ber) and ber < 0.5, ber)


def phase_e_coded():
    from ofdm_lte_tpu.coding import turbo
    cfg = LTEConfig(bandwidth=5.0, modulation="QPSK")
    r, dt = timed(sweep.ber_sweep, jax.random.PRNGKey(15), cfg,
                  [0.0, 3.0, 10.0], frames_per_device=128,
                  num_ofdm_symbols=NUM_SYMBOLS, pipeline="coded",
                  coded_tb_bits=6000)
    ber = np.asarray(r.ber)
    report("e", pipeline="coded 6000-bit TB", ber=ber.tolist(),
           tbs=r.frames, sweep_s=round(dt, 2))
    check(np.all(np.isfinite(ber)) and ber[-1] == 0.0, ber)

    h, dt = timed(sweep.harq_sweep, jax.random.PRNGKey(16), cfg,
                  [-2.0, 0.0, 10.0], frames_per_device=128, tb_bits=6000,
                  rv_sequence=(0, 1))
    bler = np.asarray(h.bler)
    report("e", pipeline="harq rv(0,1)", bler=bler.tolist(),
           bler_per_stage=np.asarray(h.bler_per_stage).tolist(),
           avg_tx=np.asarray(h.avg_transmissions).tolist(),
           sweep_s=round(dt, 2))
    check(np.all(np.isfinite(bler)) and bler[-1] == 0.0, bler)

    K = 6144
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 2, (16, K)).astype(np.int32)
    enc = np.asarray(turbo.turbo_encode(jnp.asarray(bits), K), np.float32)
    sigma = 0.6
    y = 1.0 - 2.0 * enc + sigma * rng.standard_normal(enc.shape)
    llr = jnp.asarray((2.0 * y / sigma ** 2).astype(np.float32))
    hard = {}
    for impl in ("scan", "block"):
        os.environ["OFDM_LTE_TPU_BCJR"] = impl
        try:
            t0 = time.perf_counter()
            compiled = jax.jit(lambda l: turbo.turbo_decode(
                l, K, num_iterations=8)).lower(llr).compile()
            compile_s = time.perf_counter() - t0
        finally:
            del os.environ["OFDM_LTE_TPU_BCJR"]
        hard[impl], dt = timed(compiled, llr)
        hard[impl] = np.asarray(hard[impl])
        report("e", bcjr=impl, K=K, codewords=bits.shape[0],
               bit_errors=int(np.sum(hard[impl] != bits)),
               compile_s=round(compile_s, 2), run_s=round(dt, 3),
               memory=memory(compiled.memory_analysis()))
    check(np.array_equal(hard["scan"], hard["block"]), "BCJR kernels differ")


def phase_f_cli():
    from ofdm_lte_tpu import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["sweep", "--bandwidth", "20", "--modulation", "64-QAM",
                  "--snr-min", "15", "--snr-max", "60", "--snr-step", "45",
                  "--frames", "256", "--num-symbols", "14"])
    res = json.loads(out.getvalue())
    ber = res["ber"]
    report("f", cli="sweep", snr_db=res["snr_db"], ber=ber,
           total_bits=res["total_bits"],
           run_s=round(time.perf_counter() - t0, 2))
    check(len(ber) == 2 and 0.0 < ber[0] < 0.5 and ber[1] == 0.0, res)


def phase_g_multi():
    """The sharded sweeps on four cards, against the same total frames on
    one card."""
    import __graft_entry__
    n = 4
    check(len(jax.devices()) >= n, f"--multi needs {n} GPUs")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n, bandwidth=20.0)
    report("g", dryrun_multichip=n, run_s=round(time.perf_counter() - t0, 2))

    cfg = LTEConfig(bandwidth=20.0, modulation="64-QAM")
    snrs = [10.0, 20.0, 60.0]
    frames = 256              # per card; the one-card run takes all four
    one = sweep.make_mesh(jax.devices()[:1])
    r1, dt1 = timed(sweep.ber_sweep, jax.random.PRNGKey(21), cfg, snrs,
                    frames_per_device=frames * n,
                    num_ofdm_symbols=NUM_SYMBOLS, mesh=one)
    meshes = {"1d": sweep.make_mesh(jax.devices()[:n]),
              "2d": sweep.make_mesh_2d(2, jax.devices()[:n])}
    for name, mesh in meshes.items():
        # a 2-D mesh's 'snr' rows split the points; 'mc' splits frames
        per_dev = frames * n // mesh.shape["mc"]
        r, dt = timed(sweep.ber_sweep, jax.random.PRNGKey(22), cfg, snrs,
                      frames_per_device=per_dev,
                      num_ofdm_symbols=NUM_SYMBOLS, mesh=mesh)
        ber1, ber4 = np.asarray(r1.ber), np.asarray(r.ber)
        # independent runs: the bits of one QAM symbol can err together,
        # so the binomial trials are symbols, each at the bit error rate
        n_sym = int(np.asarray(r.total_bits)[0]) // cfg.bits_per_symbol
        bounds = [binomial_bound(max(a, b), n_sym) for a, b in
                  zip(ber1, ber4)]
        report("g", mesh=name, shape=dict(mesh.shape), ber_4=ber4.tolist(),
               ber_1=ber1.tolist(), frames=r.frames, sweep_s=round(dt, 2),
               sweep_1card_s=round(dt1, 2))
        check(r.frames == r1.frames, (r.frames, r1.frames))
        check(ber4[-1] == 0.0 and ber1[-1] == 0.0, (ber1, ber4))
        check(all(abs(a - b) <= c for a, b, c in zip(ber1, ber4, bounds)),
              (ber1, ber4, bounds))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded sweeps")
    args = p.parse_args(argv)

    dev = check_device()
    enable_compile_cache()
    print(f"# card: {gpu_name_and_power_limit()}", flush=True)
    print(f"# jax {jax.__version__}: {len(jax.devices())} x "
          f"{dev.device_kind}", flush=True)

    phases = ([phase_g_multi] if args.multi else
              [phase_a_modem, phase_b_siso, phase_c_spatial, phase_d_fading,
               phase_e_coded, phase_f_cli])
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"# {phase.__name__}: {time.perf_counter() - t0:.1f} s "
              f"{'FAILED' if phase.__name__ in failed else 'ok'}",
              flush=True)
    if failed:
        print(f"# failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
