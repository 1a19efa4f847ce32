"""Profiling and roofline accounting.

The reference's only instrumentation is wall-clock prints
(/root/reference/core/ofdm_system.py:249-280) and a thread-pool benchmark
(core/parallel_processing.py:181-223). Here:

- `trace(...)`: context manager around jax.profiler for TensorBoard-readable
  device traces;
- `benchmark(fn, *args)`: compile-then-steady-state timing with
  block_until_ready;
- analytic FLOP/byte models of the pipelines' dominant kernels (the DFT
  matmuls and the Jakes sinusoid matmul) and a roofline report comparing
  achieved FLOP/s and bytes/s against chip peaks.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict

import jax

from ..config import LTEConfig
from ..grid import grid_for


# Published dense peaks (no sparsity) keyed by jax Device.device_kind, from
# NVIDIA's H100 data sheets. They assume the card's full power limit; a card
# capped below it (nvidia-smi power.limit) cannot hold them under load.
# Units: "bf16" and "tf32" are the tensor cores, "fp32" is float32 outside
# them (elementwise work also runs there), "hbm" is device memory in B/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {           # SXM5, 700 W
        "bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12},
    "NVIDIA H100 PCIe": {                # 350 W
        "bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "hbm": 2.0e12},
}

# The unit each matmul-precision policy (ofdm_lte_tpu.precision) runs its
# float32 dots on here: `default` allows TF32, `highest` keeps float32;
# `high` is what the compiled HLO on the card shows (PERF.md).
PRECISION_UNIT = {"default": "tf32", "high": "tf32", "highest": "fp32"}

VECTOR = "fp32"          # elementwise, RNG and reduction work


def peaks_for(device_kind: str) -> Dict[str, float]:
    """Published peaks of `device_kind`; an unknown kind is an error, never
    a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add them to PEAKS") from None


def _fraction_fields(costs, measured_step_s: float, peaks) -> Dict:
    """Roofline fields for a cost dict against a MEASURED per-step time.

    `roofline_fraction` models what the program executes PER STEP under the
    bench's fixed-codeword Monte-Carlo harness: stages marked
    loop_invariant (the TX side — it depends only on the constant bits)
    are assumed hoisted out of the timed step loop by XLA, so they are
    excluded (ROADMAP 1.4 asks for a trace to confirm it on the card).
    `full_chain_roofline_s` keeps the all-stages model, and
    `full_chain_model_over_measured_x` reports how many times the modeled
    full chain exceeds the measured step."""
    steady = {k: c for k, c in costs.items() if not c.loop_invariant}
    t_steady = sum(c.roofline_time_s(peaks) for c in steady.values())
    t_full = sum(c.roofline_time_s(peaks) for c in costs.values())
    return {
        "roofline_s": t_steady,
        "roofline_fraction": t_steady / measured_step_s
        if measured_step_s else 0.0,
        "full_chain_roofline_s": t_full,
        "full_chain_model_over_measured_x": t_full / measured_step_s
        if measured_step_s else 0.0,
        "hoisted_stages": sorted(k for k, c in costs.items()
                                 if c.loop_invariant),
        "per_kernel_us": {k: round(c.roofline_time_s(peaks) * 1e6, 1)
                          for k, c in costs.items()},
    }


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, n_steps: int = 10) -> Dict:
    """Returns compile time, steady-state step time and throughput factor."""
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n_steps):
        out = fn(*args)
    jax.block_until_ready(out)
    step_s = (time.perf_counter() - t0) / n_steps
    return {"compile_s": compile_s, "step_s": step_s}


@dataclass
class KernelCost:
    name: str
    flops: float
    bytes: float
    unit: str = VECTOR                   # a PEAKS unit: its flops run there
    # True for stages that depend only on the (constant) TX bits, not on
    # the per-step PRNG key: under the bench's fixed-codeword Monte-Carlo
    # harness XLA can hoist them out of the timed step loop, so the
    # per-step roofline excludes them
    loop_invariant: bool = False

    def roofline_time_s(self, peaks) -> float:
        return max(self.flops / peaks[self.unit], self.bytes / peaks["hbm"])


def _cmatmul_cost(name, m, k, n, unit, dtype_bytes=4,
                  loop_invariant=False) -> KernelCost:
    """Complex matmul in the 8·m·k·n effective-FLOP convention (4 real
    matmuls; the gauss 3-multiply path executes 6mkn); operands+result
    re/im pairs."""
    flops = 8.0 * m * k * n
    byts = dtype_bytes * 2 * (m * k + k * n + m * n)
    return KernelCost(name, flops, byts, unit, loop_invariant=loop_invariant)


def siso_frame_cost(config: LTEConfig, num_symbols: int = 14,
                    lanes: int = 1,
                    precision: str = "highest",
                    bits_dtype_bytes: int = 1,
                    awgn_mode: str = "freq") -> Dict[str, KernelCost]:
    """Complete-program cost model for one SISO frame batch: every stage the
    program must execute at the speed-of-light of its unit (matmuls on the
    precision's unit, elementwise/RNG work, device-memory passes). A matmul-only model understates the
    mandatory work — the AWGN channel alone is three full passes over the
    time-domain signal plus two Gaussian draws per sample — and so reports
    an artificially low roofline fraction for a program that is in fact
    near the hardware bound.

    Per-stage accounting (T = total time-domain samples, D = data symbols):
    - tx_idft / rx_dft: the fused modem matmuls (on the unit
      PRECISION_UNIT names for the precision).
    - awgn_channel: power-measure pass (3 flops + 8 B/sample read), RNG
      (2 normals/sample, ~24 flops each for counter-based bits +
      Box-Muller transcendentals), fused scale-add (4 flops/sample).
      awgn_mode="freq" (the sim's AWGN default,
      sim/siso._receive_awgn_freq): noise is injected at the received
      data/pilot BINS — unitary-DFT equivalent — so the RNG covers
      S·n_data + n_slots·n_pil bin samples instead of S·(N+cp) time
      samples and the add fuses into the demod matmul epilogue (no rx
      time-signal write). awgn_mode="time" models the generic path
      (channel/awgn.py: full time-domain noise + separate rx write).
    - qam_demap: closed-form per-axis hard decision ~30 flops/symbol, plus
      LLR-free bit emission (8 B/symbol in, bits out).
    - estimate_zf: LS at pilots + lerp + per-bin complex divide,
      ~14 flops/data bin + one H read.
    """
    g = grid_for(config)
    S = lanes * num_symbols
    sps = config.samples_per_ofdm_symbol
    T = S * sps                                   # time-domain samples
    D = S * g.num_data                            # data QAM symbols
    n_slots = max(1, num_symbols // 7)            # CRS slot starts
    # noise samples the RNG must produce (complex): all time samples in
    # "time" mode, only the received data+pilot bins in "freq" mode
    Tb = (D + lanes * n_slots * g.num_pilot) if awgn_mode == "freq" else T
    bits_per = config.bits_per_symbol
    bB = bits_dtype_bytes      # bench feeds int8 bit arrays (1 B/bit);
    #                            int32 callers pay 4 B/bit here
    mm = PRECISION_UNIT[precision]
    # loop-invariant tags: under a fixed-codeword harness the TX side
    # (and, in freq-AWGN mode, both RX DFTs of the then-constant signal)
    # depends only on the bits — XLA hoists it out of the step loop
    inv_rx = awgn_mode == "freq"
    costs = {
        "tx_idft": _cmatmul_cost("tx_idft", S, g.num_data, sps, mm,
                                 loop_invariant=True),
        "rx_dft_data": _cmatmul_cost("rx_dft_data", S, config.N,
                                     g.num_data, mm,
                                     loop_invariant=inv_rx),
        "rx_dft_pilot": _cmatmul_cost(
            "rx_dft_pilot", lanes * max(1, num_symbols // 14), config.N,
            g.num_pilot, mm, loop_invariant=inv_rx),
        # noise power from the (constant) TX signal: hoisted
        "awgn_sigma": KernelCost(
            "awgn_sigma", flops=3.0 * T, bytes=8.0 * T,
            unit=VECTOR,
            loop_invariant=True),
        # the per-step noise draw + scale-add
        "awgn_rng_add": KernelCost(
            "awgn_rng_add",
            flops=(2 * 24 + 4) * Tb,
            bytes=(0 if awgn_mode == "freq" else 16) * Tb,
            unit=VECTOR),
        "papr": KernelCost(
            # |x|² + max/mean reductions over the full TX signal
            # (ofdm.papr_db): one read of the complex signal, 4 flops/sample
            "papr", flops=4.0 * T, bytes=8.0 * T,
            unit=VECTOR,
            loop_invariant=True),
        "qam_map": KernelCost(
            # bits -> symbols: read bps ints per symbol (at the caller's
            # bit dtype width), closed-form per-axis map
            "qam_map", flops=10.0 * D, bytes=bB * bits_per * D + 8.0 * D,
            unit=VECTOR,
            loop_invariant=True),
        "qam_demap": KernelCost("qam_demap", flops=30.0 * D,
                                bytes=8.0 * D + bB * bits_per * D,
                                unit=VECTOR),
        "estimate_zf": KernelCost("estimate_zf", flops=14.0 * D,
                                  bytes=8.0 * D,
                                  unit=VECTOR),
        "bit_error_count": KernelCost(
            # compare RX bits vs TX bits + reduction: two bit-array reads
            # at the caller's dtype width
            "bit_error_count", flops=2.0 * bits_per * D,
            bytes=2.0 * bB * bits_per * D, unit=VECTOR),
    }
    return costs


def spatial_frame_cost(config: LTEConfig, num_symbols: int = 14,
                       lanes: int = 1, num_tx: int = 2, num_rx: int = 2,
                       rank: int = 2,
                       precision: str = "default",
                       bits_dtype_bytes: int = 1,
                       channel_impl: str = "bins") -> Dict[str, KernelCost]:
    """Complete-program cost model for the TM4 spatial-multiplexing step
    (sim/spatial._simulate_spatial_jit; reference workload
    /root/reference/core/ofdm_core.py:2489-2816). Default models the
    bin-domain flat-channel pipeline (PARITY.md divergence 7); set
    channel_impl="time" for the time-domain arbiter path (adds the RX
    DFT matmuls, the time-domain mixing pass and the RX time signals).

    Notation: B = lanes·S batched OFDM symbols, m = data bins per layer,
    T = B·sps time samples per antenna, Dq = lanes·S·nd data QAM symbols,
    E = num_rx·num_tx·B·m estimated channel points.
    """
    from ..grid import make_grid
    from ..mimo.layer_mapper import padded_length
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    nd = g.num_data
    m = padded_length(nd, rank) // rank
    n_pil = g.num_pilot
    Dq = lanes * S * nd                    # QAM symbols
    T = B * sps                            # time samples per antenna
    E = num_rx * num_tx * B * m            # channel-estimate points
    Nb = num_rx * B * (m + n_pil)          # noisy bin samples (complex)
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    mm = PRECISION_UNIT[precision]
    costs = {
        # bits -> QAM symbols -> zero-pad -> layers -> W precode;
        # loop-invariant under the fixed-codeword harness (constant bits)
        "qam_map_precode": KernelCost(
            "qam_map_precode",
            flops=(10.0 + 8.0 * rank) * Dq,
            bytes=bB * bps * Dq + 8.0 * Dq + 8.0 * num_tx * lanes * S * m,
            unit=VECTOR,
            loop_invariant=True),
        # fused scatter+IDFT+CP: ONE batched cmatmul over the antenna axis
        "tx_idft": KernelCost(
            "tx_idft",
            flops=8.0 * (B * num_tx) * m * sps,
            bytes=8.0 * B * num_tx * (m + sps),
            unit=mm,
            loop_invariant=True),
        # PAPR + TX cross-correlation pass: one fused read of the TX
        # signals, ~8 flops/sample (|x|², max/mean, num_tx² corr FMAs)
        "papr_corr": KernelCost(
            "papr_corr", flops=8.0 * num_tx * T,
            bytes=8.0 * num_tx * T, unit=VECTOR,
            loop_invariant=True),
        # bin-domain channel: per-RX mixing FMAs + CN noise (counter RNG
        # ~24 flops/normal + fused scale-add), one plane write
        "channel_bins": KernelCost(
            "channel_bins",
            flops=(8.0 * num_tx + 2 * 24 + 4) * Nb,
            bytes=8.0 * Nb + 8.0 * num_rx * B * m,   # write + re-read x
            unit=VECTOR),
        # per-symbol per-TX LS + lerp to the data bins: ~14 flops and one
        # plane write per estimate point (pilot reads are table-sized)
        "estimate_per_tx": KernelCost(
            "estimate_per_tx", flops=14.0 * E, bytes=8.0 * E,
            unit=VECTOR),
        # fused closed-form 2x2 MMSE on planes: reads 2·y + rank·num_rx·h
        # planes, ~(30 + 16·num_rx·rank) flops/bin, writes rank planes
        "detect_mmse2": KernelCost(
            "detect_mmse2",
            flops=(30.0 + 16.0 * num_rx * rank) * B * m,
            bytes=8.0 * B * (m * (num_rx + num_rx * num_tx + rank)),
            unit=VECTOR),
        # layer interleave + hard demap + bit compare/count
        "demap_count": KernelCost(
            "demap_count", flops=(30.0 + 2.0 * bps) * Dq,
            bytes=8.0 * 2 * Dq + 2.0 * bB * bps * Dq,
            unit=VECTOR),
    }
    if channel_impl == "time":
        # the arbiter path materializes RX time signals: per-RX mixing
        # over T samples, power measure, and num_rx DFT matmuls back to
        # the data+pilot bins
        costs["channel_bins"] = KernelCost(
            "channel_time",
            flops=(8.0 * num_tx + 3) * num_rx * T + (2 * 24 + 4) * Nb,
            bytes=8.0 * (num_tx + 2 * num_rx) * T,
            unit=VECTOR)
        costs["rx_dft"] = KernelCost(
            "rx_dft",
            flops=8.0 * (B * num_rx) * config.N * (m + n_pil),
            bytes=8.0 * B * num_rx * (config.N + m + n_pil),
            unit=mm)
    return costs


def _report(costs: Dict[str, KernelCost], measured_step_s: float,
            precision: str, device_kind: str, **extra) -> Dict:
    """Roofline fields of a cost dict against a measured step on
    `device_kind`'s published peaks."""
    return {
        "precision": precision,
        "device_kind": device_kind,
        "modeled_gflops": sum(c.flops for c in costs.values()) / 1e9,
        "modeled_gbytes": sum(c.bytes for c in costs.values()) / 1e9,
        "measured_s": measured_step_s,
        **extra,
        **_fraction_fields(costs, measured_step_s, peaks_for(device_kind)),
    }


def spatial_roofline_report(config: LTEConfig, num_symbols: int, lanes: int,
                            measured_step_s: float, device_kind: str,
                            num_tx: int = 2, num_rx: int = 2, rank: int = 2,
                            precision: str = "default",
                            channel_impl: str = "bins") -> Dict:
    """Roofline fraction for the spatial step."""
    costs = spatial_frame_cost(config, num_symbols, lanes, num_tx, num_rx,
                               rank, precision, channel_impl=channel_impl)
    return _report(costs, measured_step_s, precision, device_kind,
                   channel_impl=channel_impl)


def _jakes_channel_costs(T_samples: float, links: float, num_taps: int,
                         precision: str,
                         x_reads: float = 1.0,
                         tap_hold: int = None,
                         profile=None) -> Dict[str, KernelCost]:
    """The channel-FIR kernel family (BASELINE.md:38): the Jakes
    sum-of-sinusoids generator expressed as ONE complex matmul
    P(L, Ns) @ E(Ns, Tg) (channel/rayleigh.jakes_taps; reference loop:
    /root/reference/core/rayleighchannel.py:20-58) plus the per-tap
    delayed FMA y(t) = Σ_i g_i·h_i(t)·x(t-d_i).

    T_samples: time samples per link; links: total (leg · lane) count;
    x_reads: how many times the input signal is re-read across legs;
    tap_hold: tap-hold granularity (None = the active runtime default
    from channel.rayleigh._tap_hold, so the model matches the measured
    configuration — Tg = T/hold tap samples instead of T)."""
    ns = 16
    L = links * num_taps
    if tap_hold is None and profile is not None:
        from ..channel.rayleigh import _tap_hold
        tap_hold = _tap_hold(int(T_samples), profile)
    tap_hold = max(1, tap_hold or 1)
    Tg = T_samples / tap_hold
    mm = PRECISION_UNIT[precision]
    return {
        # 4-multiply complex matmul (cplx.matmul — not the modem's gauss
        # path): 8·L·Ns·Tg flops, dominated by the (L, Tg) tap-waveform
        # write (E/P operands are KB-sized)
        "jakes_matmul": KernelCost(
            "jakes_matmul", flops=8.0 * L * ns * Tg,
            bytes=8.0 * L * Tg, unit=mm),
        # per-tap delayed FMA: reads every (held) tap waveform once, the
        # input signal x_reads times, writes the faded sum
        "tap_fma": KernelCost(
            "tap_fma", flops=8.0 * L * T_samples,
            bytes=8.0 * (L * Tg / max(T_samples, 1.0) + links * x_reads
                         + links) * T_samples,
            unit=VECTOR),
    }


def _bench_profile(config: LTEConfig):
    """The bench workloads' channel profile (Ped-A, 3 km/h, 2 GHz) — used
    to resolve the active tap-hold granularity for the cost model."""
    from ..channel.rayleigh import make_profile
    return make_profile("Pedestrian_A", config.fs, 3.0, 2.0)


def simo_frame_cost(config: LTEConfig, num_symbols: int = 14,
                    lanes: int = 1, num_rx: int = 4, num_taps: int = 4,
                    precision: str = "default",
                    bits_dtype_bytes: int = 1) -> Dict[str, KernelCost]:
    """Complete-program cost model for the SIMO 1xN MRC Rayleigh chain
    (sim/diversity.simulate_simo; reference ofdm_core.py:1536-1679 +
    rayleighchannel.py:44-58): SISO TX matmul, per-leg Jakes multipath
    (the channel-FIR family), per-leg time-domain AWGN, per-RX data DFT +
    slot-start pilot DFT, LS+lerp estimation, MRC combine, demap."""
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    nd = g.num_data
    n_pil = g.num_pilot
    n_slots = max(1, S // 14)
    T = B * sps                       # time samples per antenna stream
    D = B * nd
    M = num_rx * T                    # noisy time samples
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    mm = PRECISION_UNIT[precision]
    costs = {
        "qam_map": KernelCost("qam_map", flops=10.0 * D,
                              bytes=bB * bps * D + 8.0 * D,
                              unit=VECTOR, loop_invariant=True),
        "tx_idft": KernelCost("tx_idft", flops=8.0 * B * nd * sps,
                              bytes=8.0 * B * (nd + sps), unit=mm, loop_invariant=True),
        "papr": KernelCost("papr", flops=4.0 * T, bytes=8.0 * T,
                           unit=VECTOR, loop_invariant=True),
        **_jakes_channel_costs(S * sps, num_rx * lanes, num_taps,
                               precision,
                               profile=_bench_profile(config)),
        # per-leg time-domain AWGN (kept deliberately, see
        # sim/diversity.py: bin noise regressed via rematerialization):
        # power pass + counter RNG + fused scale-add
        "awgn_legs": KernelCost(
            "awgn_legs", flops=(3.0 + 2 * 24 + 4) * M,
            bytes=16.0 * M, unit=VECTOR),
        "rx_dft_data": KernelCost(
            "rx_dft_data", flops=8.0 * num_rx * B * config.N * nd,
            bytes=8.0 * num_rx * B * (config.N + nd), unit=mm),
        "rx_dft_pilot": KernelCost(
            "rx_dft_pilot",
            flops=8.0 * num_rx * lanes * n_slots * config.N * n_pil,
            bytes=8.0 * num_rx * lanes * n_slots * (config.N + n_pil),
            unit=mm),
        # LS + lerp to data bins (slot-periodic: n_slots estimates
        # broadcast over S) + MRC combine over the antenna axis
        "estimate_mrc": KernelCost(
            "estimate_mrc",
            flops=14.0 * num_rx * lanes * n_slots * nd
            + 16.0 * num_rx * D + 6.0 * D,
            bytes=8.0 * num_rx * D * 2 + 8.0 * D,
            unit=VECTOR),
        "qam_demap_count": KernelCost(
            "qam_demap_count", flops=(30.0 + 2.0 * bps) * D,
            bytes=8.0 * D + 2.0 * bB * bps * D, unit=VECTOR),
    }
    return costs


def sfbc_frame_cost(config: LTEConfig, num_symbols: int = 14,
                    lanes: int = 1, num_rx: int = 1, num_taps: int = 4,
                    precision: str = "default",
                    bits_dtype_bytes: int = 1) -> Dict[str, KernelCost]:
    """Complete-program cost model for the 2xN Alamouti SFBC Rayleigh
    chain (sim/diversity.simulate_sfbc; reference ofdm_core.py:1850-2258):
    2 TX modulate matmuls, 2·num_rx Jakes multipath legs (channel-FIR
    family), bin-domain per-RX noise, per-RX data DFT + slot-start pilot
    DFT, per-TX estimation, Alamouti decode, demap."""
    from ..sim.diversity import sfbc_data_bins
    g = grid_for(config)
    S = num_symbols
    B = lanes * S
    sps = config.samples_per_ofdm_symbol
    ne = len(sfbc_data_bins(config))
    n_pil = g.num_pilot
    n_slots = max(1, S // 14)
    D = B * ne
    Nb = num_rx * (D + lanes * n_slots * n_pil)   # noisy bin samples
    bps = config.bits_per_symbol
    bB = bits_dtype_bytes
    mm = PRECISION_UNIT[precision]
    costs = {
        "qam_map_alamouti": KernelCost(
            "qam_map_alamouti", flops=16.0 * D,
            bytes=bB * bps * D + 8.0 * 2 * D, unit=VECTOR, loop_invariant=True),
        "tx_idft": KernelCost("tx_idft", flops=8.0 * 2 * B * ne * sps,
                              bytes=8.0 * 2 * B * (ne + sps),
                              unit=mm, loop_invariant=True),
        "papr": KernelCost("papr", flops=4.0 * 2 * B * sps,
                           bytes=8.0 * 2 * B * sps,
                           unit=VECTOR, loop_invariant=True),
        **_jakes_channel_costs(S * sps, 2 * num_rx * lanes, num_taps,
                               precision,
                               profile=_bench_profile(config)),
        "bin_noise": KernelCost(
            "bin_noise", flops=(2 * 24 + 4) * Nb + 3.0 * num_rx * B * sps,
            bytes=8.0 * Nb + 8.0 * num_rx * B * sps,
            unit=VECTOR),
        "rx_dft_data": KernelCost(
            "rx_dft_data", flops=8.0 * num_rx * B * config.N * ne,
            bytes=8.0 * num_rx * B * (config.N + ne), unit=mm),
        "rx_dft_pilot": KernelCost(
            "rx_dft_pilot",
            flops=8.0 * num_rx * lanes * n_slots * config.N * n_pil,
            bytes=8.0 * num_rx * lanes * n_slots * (config.N + n_pil),
            unit=mm),
        # per-TX LS+lerp (slot-periodic) + Alamouti pair decode
        "estimate_decode": KernelCost(
            "estimate_decode",
            flops=14.0 * 2 * num_rx * lanes * n_slots * ne + 24.0 * num_rx * D,
            bytes=8.0 * 2 * num_rx * D + 8.0 * D,
            unit=VECTOR),
        "qam_demap_count": KernelCost(
            "qam_demap_count", flops=(30.0 + 2.0 * bps) * D,
            bytes=8.0 * D + 2.0 * bB * bps * D, unit=VECTOR),
    }
    return costs


def fir_roofline_report(costs: Dict[str, KernelCost],
                        measured_step_s: float, device_kind: str,
                        precision: str = "default") -> Dict:
    """Roofline fraction for a cost dict (simo_frame_cost /
    sfbc_frame_cost). Reports the channel-FIR kernel family's share
    separately."""
    peaks = peaks_for(device_kind)
    fir_s = sum(c.roofline_time_s(peaks) for k, c in costs.items()
                if k in ("jakes_matmul", "tap_fma"))
    return _report(costs, measured_step_s, precision, device_kind,
                   channel_fir_roofline_s=fir_s)


def roofline_report(config: LTEConfig, num_symbols: int, lanes: int,
                    measured_step_s: float, device_kind: str,
                    precision: str = "highest",
                    bits_dtype_bytes: int = 1,
                    awgn_mode: str = "freq") -> Dict:
    costs = siso_frame_cost(config, num_symbols, lanes, precision,
                            bits_dtype_bytes, awgn_mode)
    total_flops = sum(c.flops for c in costs.values())
    # full-chain flops over the measured step: the AMORTIZED rate the
    # fixed-codeword harness effectively delivers (hoisted TX included in
    # the numerator) — a throughput figure, not a unit fraction
    return _report(costs, measured_step_s, precision, device_kind,
                   effective_amortized_tflops=total_flops / measured_step_s
                   / 1e12 if measured_step_s else 0.0)
